"""Model and generator factory (port of vtaco_tpu/core/factory.py:44-183
and the registries of vtaco_tpu/core/registry.py:37-55).

Builds every key of the JAX package's registries: the object ``encoder``
(pointnet_local_pool; pointnet_crop_local_pool, the crop form;
pointnet_plus_plus; voxel_simple_local; or ``idx``, a latent per dataset
sample), the hand ``encoder_hand`` (pointnet_local_pool on planes, with
its MANO head) and ``mano_layer``, the tactile ``encoder_img``
(Resnet18/34/50, or the depth U-Net of the tactile configs), the nested
tactile-to-depth model ``encoder_t2d`` (a hand encoder and the depth
U-Net) and the ``decoder`` (simple_local, with the contact head under
``model.with_contact``; simple_local_crop; attention_local;
simple_local_point). An ``encoder`` or ``decoder`` set to false (or
null) is not built, as in the tactile depth-stack configs. As the JAX
package's ``_filter_kwargs`` does, each constructor takes the config
keys it declares and drops the others (the reference configs'
``start_flits`` becomes ``start_filts``, ``in_channel`` is dropped).

As in the JAX package, ``data.unit_size`` and ``model.local_coord`` /
``model.pos_encoding`` overwrite the entries of the encoder, hand
encoder and decoder kwargs, and a ``pointcloud_crop`` model takes its
feature resolution from the dataset it is built for: the train crop's
(``query_vol_size`` + the receptive field - 1, rounded up for the U-Net)
for the train split or ``generation.sliding_window``, else the whole
scene's (``dataset.total_reso``). Unlike the JAX package, get_model
leaves ``cfg`` as it is.
"""

from __future__ import annotations

import copy
import inspect

from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork
from vtaco_tpu_torch.models.decoder import (
    AttentionDecoder,
    LocalDecoder,
    LocalPointDecoder,
    PatchLocalDecoder,
)
from vtaco_tpu_torch.models.layers import Resnet18, Resnet34, Resnet50, TactileUNet
from vtaco_tpu_torch.models.mano import ManoLayer
from vtaco_tpu_torch.models.pointnet import (
    IndexEncoder,
    LocalPoolPointnet,
    PatchLocalPoolPointnet,
)
from vtaco_tpu_torch.models.pointnetpp import PointNetPlusPlus
from vtaco_tpu_torch.models.voxels import LocalVoxelEncoder
from vtaco_tpu_torch.ops.geometry import crop_levels, update_reso

encoder_dict = {"pointnet_local_pool": LocalPoolPointnet,
                "pointnet_crop_local_pool": PatchLocalPoolPointnet,
                "pointnet_plus_plus": PointNetPlusPlus,
                "voxel_simple_local": LocalVoxelEncoder,
                "Resnet18": Resnet18, "Resnet34": Resnet34, "Resnet50": Resnet50,
                "UNet": TactileUNet}
decoder_dict = {"simple_local": LocalDecoder, "attention_local": AttentionDecoder,
                "simple_local_crop": PatchLocalDecoder,
                "simple_local_point": LocalPointDecoder}


def _lookup(table, name, what):
    if name not in table:
        raise NotImplementedError(
            f"{what} {name!r} is not ported yet (ROADMAP.md lists the queue)")
    return table[name]


def _build(cls, kw):
    """cls on the config keys its constructor declares."""
    kw = dict(kw)
    if "start_flits" in kw:   # the reference configs' typo
        kw.setdefault("start_filts", kw.pop("start_flits"))
    kw.pop("in_channel", None)
    declared = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kw.items() if k in declared})


def _build_encoder(name, kw, what):
    return _build(_lookup(encoder_dict, name, what), kw)


def _hand_encoder(name, kw, dim, padding, c_dim=None):
    """(encoder, out_dim, manolayer_kwargs) from encoder_hand_kwargs."""
    kw = dict(kw or {})
    kw.update(dim=dim, padding=padding)
    if c_dim is not None:
        kw.setdefault("c_dim", c_dim)
    return (_build_encoder(name, kw, "encoder_hand"),
            int(kw.get("out_dim") or 0), kw.get("manolayer_kwargs"))


def _crop_resolution(cfg, dataset):
    """The feature resolution of a pointcloud_crop model built for
    ``dataset``."""
    if getattr(dataset, "split", None) == "train" or cfg["generation"].get("sliding_window"):
        recep_field = crop_levels(cfg["model"]["encoder_kwargs"])[0]
        return update_reso(cfg["data"]["query_vol_size"] + recep_field - 1, dataset.depth)
    return dataset.total_reso


def get_model(cfg, device="cuda", return_aux=False, dataset=None):
    """Build the ConvOccupancyNetwork for cfg on ``device``, in eval mode,
    with PyTorch's default initialization (seed it with torch.manual_seed,
    or load weights with core.weights.load_jax_params). With
    ``return_aux`` it returns (model, aux), aux carrying
    ``t2d_pretrained_file``: the checkpoint the trainer grafts the
    pretrained tactile-to-depth weights from, or None. ``dataset``
    (data.core.Shapes3dDataset) sets a crop model's resolution and the
    number of ``idx`` latents (one without it)."""
    mcfg = copy.deepcopy(cfg["model"])
    prop = {k: mcfg[k] for k in ("local_coord", "pos_encoding") if k in mcfg}
    if "unit_size" in cfg["data"]:
        prop["unit_size"] = cfg["data"]["unit_size"]
    for kwname in ("encoder_kwargs", "encoder_hand_kwargs", "decoder_kwargs"):
        if isinstance(mcfg.get(kwname), dict):
            mcfg[kwname].update(prop)
    if cfg["data"].get("input_type") == "pointcloud_crop" and dataset is not None:
        enc_kw = mcfg["encoder_kwargs"]
        reso = _crop_resolution(cfg, dataset)
        if "grid" in enc_kw["plane_type"]:
            enc_kw["grid_resolution"] = reso
        if set(enc_kw["plane_type"]) & {"xz", "xy", "yz"}:
            enc_kw["plane_resolution"] = reso
    dim, c_dim = cfg["data"]["dim"], mcfg["c_dim"]
    padding = cfg["data"]["padding"]

    decoder = encoder = None
    if mcfg.get("decoder") not in (False, None):
        kw = dict(mcfg.get("decoder_kwargs") or {})
        kw.update(dim=dim, c_dim=c_dim, padding=padding,
                  with_contact=bool(mcfg.get("with_contact")))
        decoder = _build(_lookup(decoder_dict, mcfg["decoder"], "decoder"), kw)

    if mcfg.get("encoder") == "idx":
        encoder = IndexEncoder(len(dataset) if dataset is not None else 1, c_dim)
    elif mcfg.get("encoder") not in (False, None):
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
