"""Checks and inputs that chip_smoke.py (its ``[init]`` and ``[helpers]``
phases) and tests/test_torch_cuda.py share. It imports torch only.

``check_fresh_model``: the analytic check of a freshly drawn port model.
Every floating tensor is held to the distribution its layer draws it from
(vtaco_tpu_torch/models/init.py, the JAX package's initializers), with the
fans taken here from the layer's kind, apart from the port's own
computation: a Linear's (out, in) weight has fan_in = in; a ConvNd's (out,
in, *k) fan_in = in·∏k and fan_out = out·∏k; a ConvTransposeNd's (in,
out, *k) fan_in = in·∏k. The std σ: lecun_normal 1/√fan_in (the cut
normal's own std), kaiming_out √(2/fan_out), xavier_normal
√(2/(fan_in + fan_out)), the relation normal its given std, an
embedding's 1/√features. A tensor's sample std s of n entries lies within
``Z_MAX`` standard errors of σ, the standard error σ·√((κ − 1)/(4n)) with
κ the distribution's kurtosis (3 for a normal, about 2.366 for the normal
cut at ±2); a lecun tensor also lies within its cut, 2σ/0.87962566.
Zero biases, the norms' scales and BatchNorm's running statistics are
exact (0 or 1).

``spread_matrices``: well-posed inputs of ``rotmat_projection``.
"""

import math

import torch
from torch import nn

from vtaco_tpu_torch.models import init as I
from vtaco_tpu_torch.ops import geometry as G

Z_MAX = 5.0
TRUNC_STD = 0.87962566103423978


def _cut_kurtosis(a=2.0):
    """Kurtosis of the standard normal cut at ±a."""
    phi = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
    mass = math.erf(a / math.sqrt(2))
    m2 = 1 - 2 * a * phi / mass
    m4 = 3 * m2 - 2 * a ** 3 * phi / mass
    return m4 / (m2 * m2)


KURTOSIS = {"lecun_normal_": _cut_kurtosis()}


def _fans(module, w):
    field = math.prod(w.shape[2:])
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        return w.shape[0] * field, w.shape[1] * field
    return w.shape[1] * field, w.shape[0] * field


def expected(module, leaf, t):
    """(initializer name, σ) of ``module``'s tensor ``leaf``; σ is None for
    an exact 0 or 1 (returned as the name "zeros" or "ones")."""
    if isinstance(module, (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)):
        return ("ones", None) if leaf in ("weight", "running_var") else ("zeros", None)
    init = getattr(module, "kernel_init" if leaf == "weight" else "bias_init", None)
    if init is None:
        raise AssertionError(f"{type(module).__name__}.{leaf} has no initializer")
    fn = getattr(init, "func", init)
    if fn is I.zeros_:
        return "zeros", None
    if fn is I.ones_:
        return "ones", None
    if fn is I.normal_:
        return "relation_normal", init.keywords["std"]
    if fn is I.embed_normal_:
        return fn.__name__, t.shape[1] ** -0.5
    fan_in, fan_out = _fans(module, t)
    std = {I.lecun_normal_: fan_in ** -0.5, I.kaiming_out_: (2.0 / fan_out) ** 0.5,
           I.xavier_normal_: (2.0 / (fan_in + fan_out)) ** 0.5}[fn]
    return fn.__name__, std


@torch.no_grad()
def check_fresh_model(model):
    """{"tensors", "exact", "drawn", "worst_z", "worst", "failures"} of a
    freshly drawn model: every floating tensor of its state_dict (the
    parameters and BatchNorm's statistics) against its initializer."""
    modules = dict(model.named_modules())
    out = {"tensors": 0, "exact": 0, "drawn": 0, "worst_z": 0.0, "worst": None,
           "failures": []}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            continue
        mname, _, leaf = name.rpartition(".")
        kind, std = expected(modules[mname], leaf, t)
        out["tensors"] += 1
        if std is None:
            out["exact"] += 1
            if not torch.equal(t, torch.full_like(t, 1.0 if kind == "ones" else 0.0)):
                out["failures"].append((name, kind))
            continue
        out["drawn"] += 1
        x = t.double()
        s = float(torch.sqrt(torch.mean(x * x) - torch.mean(x) ** 2))
        se = std * math.sqrt((KURTOSIS.get(kind, 3.0) - 1) / (4 * t.numel()))
        z = abs(s - std) / se
        if z > out["worst_z"]:
            out["worst_z"], out["worst"] = z, name
        if z > Z_MAX:
            out["failures"].append((name, kind, s, std, z))
        if kind == "lecun_normal_" and float(x.abs().max()) > 2 * std / TRUNC_STD:
            out["failures"].append((name, "past the cut"))
    return out


def spread_matrices(g, n):
    """n matrices U diag(s) Vᵀ, U and V random rotations, singular values
    near 1.5, 1.0 and 0.5, every other one a reflection (det < 0). The
    singular values lie apart because the projection of a matrix whose
    two smallest ones nearly meet is ill-posed: a float32 rounding of its
    SVD moves the result by about 1e-7 over their gap (near-rotations
    with a reflected column, gaps down to 0.0025: 2.4e-5 between an H100
    and the CPU, 1.9e-5 between float32 and float64 on the CPU)."""
    u = G.quat2mat(torch.randn((n, 4), generator=g))
    v = G.quat2mat(torch.randn((n, 4), generator=g))
    s = torch.tensor([1.5, 1.0, 0.5]) * (1 + 0.1 * torch.rand((n, 3), generator=g))
    s[::2, 2] *= -1
    return u @ torch.diag_embed(s) @ v.transpose(1, 2)
