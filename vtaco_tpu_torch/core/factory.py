"""Model and generator factory (port of vtaco_tpu/core/factory.py:44-183).

Builds every submodule of the VTacO configs: the object ``encoder``
(pointnet_local_pool, grid field), the hand ``encoder_hand``
(pointnet_local_pool on planes, with its MANO head) and ``mano_layer``,
the tactile ``encoder_img`` (Resnet18, or the depth U-Net of the tactile
configs), the nested tactile-to-depth model ``encoder_t2d`` (a hand
encoder and the depth U-Net) and the ``decoder`` (simple_local). An
``encoder`` or ``decoder`` set to false (or null) is not built, as in the
tactile depth-stack configs.
"""

from __future__ import annotations

from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork
from vtaco_tpu_torch.models.decoder import LocalDecoder
from vtaco_tpu_torch.models.layers import Resnet18, TactileUNet
from vtaco_tpu_torch.models.mano import ManoLayer
from vtaco_tpu_torch.models.pointnet import LocalPoolPointnet

encoder_dict = {"pointnet_local_pool": LocalPoolPointnet, "Resnet18": Resnet18,
                "UNet": TactileUNet}
decoder_dict = {"simple_local": LocalDecoder}


def _lookup(table, name, what):
    if name not in table:
        raise NotImplementedError(
            f"{what} {name!r} is not ported yet (ROADMAP.md lists the queue)")
    return table[name]


def _build_encoder(name, kw, what):
    cls = _lookup(encoder_dict, name, what)
    kw = dict(kw)
    if "start_flits" in kw:   # the reference configs' typo
        kw.setdefault("start_filts", kw.pop("start_flits"))
    kw.pop("in_channel", None)
    if cls is Resnet18:
        kw = {"num_classes": kw.get("num_classes", 32)}
    return cls(**kw)


def _hand_encoder(name, kw, dim, padding, c_dim=None):
    """(encoder, out_dim, manolayer_kwargs) from encoder_hand_kwargs."""
    kw = dict(kw or {})
    kw.update(dim=dim, padding=padding)
    if c_dim is not None:
        kw.setdefault("c_dim", c_dim)
    return (_build_encoder(name, kw, "encoder_hand"),
            int(kw.get("out_dim") or 0), kw.get("manolayer_kwargs"))


def get_model(cfg, device="cuda", return_aux=False):
    """Build the ConvOccupancyNetwork for cfg on ``device``, in eval mode,
    with PyTorch's default initialization (seed it with torch.manual_seed,
    or load weights with core.weights.load_jax_params). With
    ``return_aux`` it returns (model, aux), aux carrying
    ``t2d_pretrained_file``: the checkpoint the trainer grafts the
    pretrained tactile-to-depth weights from, or None."""
    mcfg = cfg["model"]
    if mcfg.get("with_contact"):
        raise NotImplementedError("model.with_contact (the contact-logit "
                                  "head) is not ported yet (ROADMAP.md)")
    dim, c_dim = cfg["data"]["dim"], mcfg["c_dim"]
    padding = cfg["data"]["padding"]

    decoder = encoder = None
    if mcfg.get("decoder") not in (False, None):
        kw = dict(mcfg.get("decoder_kwargs") or {})
        kw.update(dim=dim, c_dim=c_dim, padding=padding)
        decoder = _lookup(decoder_dict, mcfg["decoder"], "decoder")(**kw)

    if mcfg.get("encoder") not in (False, None):
        kw = dict(mcfg.get("encoder_kwargs") or {})
        kw.update(dim=dim, c_dim=c_dim, padding=padding)
        encoder = _build_encoder(mcfg["encoder"], kw, "encoder")

    encoder_hand, mano_layer, hand_out_dim = None, None, 0
    if mcfg.get("encoder_hand") not in (False, None):
        encoder_hand, hand_out_dim, mano_kw = _hand_encoder(
            mcfg["encoder_hand"], mcfg.get("encoder_hand_kwargs"), dim, padding, c_dim)
        if mano_kw:
            mano_layer = ManoLayer(**{k: v for k, v in mano_kw.items()
                                      if k != "mano_root"})

    encoder_img = None
    if mcfg["with_img"] and mcfg.get("encoder_img") not in (False, None):
        encoder_img = _build_encoder(mcfg["encoder_img"],
                                     mcfg.get("encoder_img_kwargs") or {}, "encoder_img")

    encoder_t2d, t2d_pretrained_file = None, None
    if mcfg.get("encoder_t2d") not in (False, None):
        tkw = mcfg["encoder_t2d_kwargs"]
        hand_enc, t2d_out_dim, _ = _hand_encoder(
            tkw["encoder_hand"], tkw.get("encoder_hand_kwargs"), dim, padding)
        encoder_t2d = ConvOccupancyNetwork(
            encoder_hand=hand_enc, hand_out_dim=t2d_out_dim,
            encoder_img=_build_encoder(tkw["encoder_img"],
                                       tkw.get("encoder_img_kwargs") or {},
                                       "encoder_t2d.encoder_img"))
        if tkw.get("pretrained"):
            t2d_pretrained_file = tkw.get("model_file")

    model = ConvOccupancyNetwork(
        decoder=decoder, encoder=encoder, encoder_hand=encoder_hand,
        encoder_img=encoder_img, encoder_t2d=encoder_t2d, mano_layer=mano_layer,
        hand_out_dim=hand_out_dim).to(device).eval()
    if return_aux:
        return model, {"t2d_pretrained_file": t2d_pretrained_file}
    return model


def get_generator(model, cfg, **kwargs):
    from vtaco_tpu_torch.generate.generator import Generator3D

    return Generator3D.from_config(model, cfg, **kwargs)
