"""The reference model of a configuration: the frozen copies of the port's
plain modules, assembled as the port's factory assembles them, without
the tactile-to-depth stack (no cell reaches it: generation reads the
ground-truth depths, ``legacy_gt_depth``). Its parameter names are the
port's, so that both load the same drawn tensors."""

from __future__ import annotations

import copy
import inspect

from port_bench.reference.conv_onet import ConvOccupancyNetwork
from port_bench.reference.decoder import LocalDecoder
from port_bench.reference.layers import Resnet18
from port_bench.reference.mano import ManoLayer
from port_bench.reference.pointnet import LocalPoolPointnet

ENCODERS = {"pointnet_local_pool": LocalPoolPointnet, "Resnet18": Resnet18}
DECODERS = {"simple_local": LocalDecoder}


def _build(cls, kw):
    kw = dict(kw)
    if "start_flits" in kw:
        kw.setdefault("start_filts", kw.pop("start_flits"))
    kw.pop("in_channel", None)
    declared = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kw.items() if k in declared})


def build(cfg: dict) -> ConvOccupancyNetwork:
    """The reference ConvOccupancyNetwork of ``cfg`` on the CPU, in eval
    mode (its parameters are the modules' own draws until loaded)."""
    m = copy.deepcopy(cfg["model"])
    dim, c_dim, padding = cfg["data"]["dim"], m["c_dim"], cfg["data"]["padding"]
    kw = dict(m.get("decoder_kwargs") or {}, dim=dim, c_dim=c_dim, padding=padding,
              with_contact=bool(m.get("with_contact")))
    decoder = _build(DECODERS[m["decoder"]], kw)
    kw = dict(m.get("encoder_kwargs") or {}, dim=dim, c_dim=c_dim, padding=padding)
    encoder = _build(ENCODERS[m["encoder"]], kw)
    encoder_hand = mano_layer = None
    hand_out_dim = 0
    if m.get("encoder_hand") not in (False, None):
        kw = dict(m.get("encoder_hand_kwargs") or {}, dim=dim, padding=padding)
        kw.setdefault("c_dim", c_dim)
        encoder_hand = _build(ENCODERS[m["encoder_hand"]], kw)
        hand_out_dim = int(kw.get("out_dim") or 0)
        mano_kw = kw.get("manolayer_kwargs")
        if mano_kw:
            mano_layer = ManoLayer(**{k: v for k, v in mano_kw.items() if k != "mano_root"})
    encoder_img = None
    if m["with_img"] and m.get("encoder_img") not in (False, None):
        encoder_img = _build(ENCODERS[m["encoder_img"]], m.get("encoder_img_kwargs") or {})
    return ConvOccupancyNetwork(decoder=decoder, encoder=encoder, encoder_hand=encoder_hand,
                                encoder_img=encoder_img, mano_layer=mano_layer,
                                hand_out_dim=hand_out_dim).eval()
