"""Model and generator factory (port of vtaco_tpu/core/factory.py:44,180).

Builds the submodules that serving needs: the object ``encoder``
(pointnet_local_pool, grid field), the tactile ``encoder_img`` (Resnet18)
and the ``decoder`` (simple_local). The hand encoder and the nested
tactile-to-depth model are not built in this slice: contact gating with
``legacy_gt_depth: true`` (the default) never runs them.
"""

from __future__ import annotations

from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork
from vtaco_tpu_torch.models.decoder import LocalDecoder
from vtaco_tpu_torch.models.layers import Resnet18
from vtaco_tpu_torch.models.pointnet import LocalPoolPointnet

encoder_dict = {"pointnet_local_pool": LocalPoolPointnet, "Resnet18": Resnet18}
decoder_dict = {"simple_local": LocalDecoder}


def _lookup(table, name, what):
    if name not in table:
        raise NotImplementedError(
            f"{what} {name!r} is not ported yet (ROADMAP.md lists the queue)")
    return table[name]


def get_model(cfg, device="cuda"):
    """Build the ConvOccupancyNetwork for cfg on ``device``, in eval mode,
    with PyTorch's default initialization (seed it with torch.manual_seed,
    or load weights with core.weights.load_jax_params)."""
    mcfg = cfg["model"]
    if mcfg.get("with_contact"):
        raise NotImplementedError("model.with_contact (the contact-logit "
                                  "head) is not ported yet (ROADMAP.md)")
    dim, c_dim = cfg["data"]["dim"], mcfg["c_dim"]
    padding = cfg["data"]["padding"]

    kw = dict(mcfg.get("decoder_kwargs") or {})
    kw.update(dim=dim, c_dim=c_dim, padding=padding)
    decoder = _lookup(decoder_dict, mcfg["decoder"], "decoder")(**kw)

    kw = dict(mcfg.get("encoder_kwargs") or {})
    kw.update(dim=dim, c_dim=c_dim, padding=padding)
    encoder = _lookup(encoder_dict, mcfg["encoder"], "encoder")(**kw)

    encoder_img = None
    if mcfg["with_img"] and mcfg.get("encoder_img") not in (False, None):
        ikw = mcfg.get("encoder_img_kwargs") or {}
        encoder_img = _lookup(encoder_dict, mcfg["encoder_img"], "encoder_img")(
            num_classes=ikw.get("num_classes", 32))

    model = ConvOccupancyNetwork(decoder=decoder, encoder=encoder,
                                 encoder_img=encoder_img)
    return model.to(device).eval()


def get_generator(model, cfg, **kwargs):
    from vtaco_tpu_torch.generate.generator import Generator3D

    return Generator3D.from_config(model, cfg, **kwargs)
