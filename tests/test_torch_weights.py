"""Weight carry-over: JAX trees load strictly into the port
(vtaco_tpu_torch/core/weights.py), and the round trip back through the JAX
package's importer is exact."""

import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu_torch.core import weights as W
from vtaco_tpu_torch.core.config import get_model

from test_torch_setup import build_pair


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_translation_matches_jax_package(pair):
    _, _, v, _ = pair
    for path in TI._flatten(v["params"]):
        assert W._translate_path(path[:-1]) == TI._translate_path(path[:-1])
    mine = W.export_state_dict(v["params"], v["batch_stats"])
    theirs = TI.export_state_dict(v["params"], v["batch_stats"])
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_load_is_strict_apart_from_named_skips(pair):
    """The port builds every submodule of the config, so the load skips
    nothing: every exported key, the hand encoder's and the nested t2d
    model's included, lands in the port, and the port has no parameter or
    buffer the tree did not fill (BatchNorm's num_batches_tracked aside)."""
    _, _, v, tmodel = pair
    sd = W.export_state_dict(v["params"], v["batch_stats"])
    own = tmodel.state_dict()
    loaded = set(sd)
    assert {k.split(".")[0] for k in loaded} == {
        "encoder", "encoder_hand", "encoder_img", "encoder_t2d", "decoder"}
    assert loaded == {k for k in own if not k.endswith("num_batches_tracked")}
    for k in loaded:
        np.testing.assert_array_equal(own[k].numpy(), sd[k], err_msg=k)


def test_round_trip_is_exact(pair):
    """JAX tree → port → torch state_dict → the JAX package's importer
    gives back the identical tree, every submodule included."""
    _, _, v, tmodel = pair
    sub, sub_stats = v["params"], v["batch_stats"]
    sd = {k: t.numpy() for k, t in tmodel.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats, report = TI.import_state_dict(sd, sub, sub_stats)
    assert not report["missing"], report["missing"][:5]
    assert not report["unused"], report["unused"][:5]
    for tree, want in ((params, sub), (stats, sub_stats)):
        for path, leaf in TI._flatten(want).items():
            np.testing.assert_array_equal(TI._flatten(tree)[path], leaf,
                                          err_msg=str(path))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_unmatched_key_raises(pair, fault):
    cfg, _, v, _ = pair
    params = {k: dict(t) for k, t in v["params"].items()}
    dec = params["decoder"]
    if fault == "missing":
        del dec["fc_out"]
    elif fault == "extra":
        dec["fc_out_contact"] = {"kernel": np.zeros((8, 1), np.float32),
                                 "bias": np.zeros((1,), np.float32)}
    else:
        dec["fc_out"] = {"kernel": np.zeros((8, 2), np.float32),
                         "bias": np.zeros((2,), np.float32)}
    with pytest.raises(RuntimeError):
        W.load_jax_params(get_model(cfg, device="cpu"), params, v["batch_stats"])


def test_unbuilt_subtree_raises_when_not_skipped(pair):
    """A JAX tree that lacks one leaf of the hand encoder fails the strict
    load, naming the missing key; so does a tree without the whole hand
    encoder, as the port builds it."""
    cfg, _, v, _ = pair
    params = {k: dict(t) for k, t in v["params"].items()}
    hand = params["encoder_hand"] = dict(params["encoder_hand"])
    fc = hand["fc_mano"] = dict(hand["fc_mano"])
    del fc["bias"]
    with pytest.raises(RuntimeError, match="encoder_hand.fc_mano.bias"):
        W.load_jax_params(get_model(cfg, device="cpu"), params, v["batch_stats"])
    params = {k: t for k, t in v["params"].items() if k != "encoder_hand"}
    stats = {k: t for k, t in v["batch_stats"].items() if k != "encoder_hand"}
    with pytest.raises(RuntimeError, match="encoder_hand"):
        W.load_jax_params(get_model(cfg, device="cpu"), params, stats)


def test_layouts(pair):
    """Dense kernels transpose; conv kernels go (*k, I, O) → (O, I, *k);
    BatchNorm statistics become running_mean/running_var."""
    _, _, v, tmodel = pair
    p, s = v["params"], v["batch_stats"]
    np.testing.assert_array_equal(tmodel.decoder.fc_p_img.weight.detach().numpy(),
                                  p["decoder"]["fc_p_img"]["kernel"].T)
    conv = p["encoder"]["unet3d_mod"]["enc1"]["SingleConv2"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        tmodel.encoder.unet3d.encoders[1].basic_module.SingleConv2.conv.weight.detach().numpy(),
        conv.transpose(4, 3, 0, 1, 2))
    bn = tmodel.encoder_img.layer2[0].downsample[1]
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  s["encoder_img"]["layer2_0"]["down_bn"]["var"])
    np.testing.assert_array_equal(bn.weight.detach().numpy(),
                                  p["encoder_img"]["layer2_0"]["down_bn"]["scale"])
    assert tmodel.decoder.fc_p.weight.dtype == torch.float32
