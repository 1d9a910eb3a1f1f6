"""Random weights from the seed, drawn on the card in two large calls.

The modules' own initializers leave the decoder's residual branches at
zero (``fc_1``), which would give a flat occupancy field and no surface.
These draws give every layer a live branch: weights are normals scaled by
1/sqrt(fan_in) (fan_in = the numel of one output row), the norms' scales
and running variances lie in [0.5, 1.5), and every other floating tensor
(biases, running means) is a normal of std 0.1. The same seed gives the
same tensors on the same card. Both the program and the reference load
the dict that ``draw`` returns.
"""

from __future__ import annotations

import torch

_NORM_NAMES = ("bn", "norm", "downsample.1")


def _kind(name: str, t: torch.Tensor) -> str:
    is_norm = any(s in name for s in _NORM_NAMES)
    if t.dim() > 1:
        return "weight"
    if name.endswith("running_var") or (is_norm and name.endswith("weight")):
        return "scale"
    return "small"


def draw(state_dict: dict, seed: int, device) -> dict:
    """{name: tensor} for every floating tensor of ``state_dict`` (a
    module's ``state_dict()``), drawn from ``seed`` on ``device``."""
    entries = [(n, t) for n, t in state_dict.items() if t.is_floating_point()]
    normal = [(n, t) for n, t in entries if _kind(n, t) != "scale"]
    uniform = [(n, t) for n, t in entries if _kind(n, t) == "scale"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    n_normal = sum(t.numel() for _, t in normal)
    n_uniform = sum(t.numel() for _, t in uniform)
    z = torch.randn(n_normal, generator=g, device=device)
    u = torch.rand(n_uniform, generator=g, device=device)
    # one scale per tensor, spread over its elements in one multiply
    scales = torch.tensor([t[0].numel() ** -0.5 if _kind(n, t) == "weight" else 0.1
                           for n, t in normal], device=device)
    counts = torch.tensor([t.numel() for _, t in normal], device=device)
    z.mul_(torch.repeat_interleave(scales, counts))
    u.add_(0.5)
    out = {}
    for flat, group in ((z, normal), (u, uniform)):
        for (n, t), piece in zip(group, torch.split(flat, [t.numel() for _, t in group])):
            out[n] = piece.view(t.shape).to(t.dtype)
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict, strict_names=True):
    """Copy ``weights`` into ``module``'s floating state. Every floating
    tensor of the module must be in ``weights``; with ``strict_names``
    every entry of ``weights`` must belong to the module."""
    state = module.state_dict()
    own = {n for n, t in state.items() if t.is_floating_point()}
    missing = own - set(weights)
    if missing:
        raise KeyError(f"no drawn tensor for {sorted(missing)[:5]}")
    extra = set(weights) - own
    if strict_names and extra:
        raise KeyError(f"drawn tensors the module lacks: {sorted(extra)[:5]}")
    for n in own:
        state[n].copy_(weights[n])


# six axes of the icosahedron, unit length
_PHI = (1 + 5 ** 0.5) / 2
_AXES = torch.tensor([[0, 1, _PHI], [0, -1, _PHI], [1, _PHI, 0], [-1, _PHI, 0],
                      [_PHI, 0, 1], [_PHI, 0, -1]]) / (1 + _PHI ** 2) ** 0.5


@torch.no_grad()
def shape_decoder(drawn: dict, scale: float, noise: float, prefix: str = "decoder."):
    """Give the drawn simple_local decoder a field with a closed surface of
    steady size: the logit is ``-scale · Σ_k |u_k · p|`` over the six
    icosahedral axes u_k (a rounded polyhedron around the box's centre),
    plus the drawn network's own output scaled by ``noise``.

    Units 0-11 of the hidden state carry ``±scale · u_k · p`` (the rows of
    ``fc_p`` and of ``fc_p_img``'s coordinate columns; their biases, their
    tactile columns, and the rows of every ``fc_c`` and residual ``fc_1``
    that write into them are zero), so that the head's ReLU gives
    ``scale · |u_k · p|`` from each pair; the head weighs them by -1 and
    every other unit by its drawn weight times ``noise``. Random weights
    leave the midpoint level of a 128³ grid anywhere between a sliver and
    a sponge of 800,000 vertices, seed to seed; the work of marching cubes
    follows the surface, so the draw fixes its size (about 60,000
    vertices) and leaves the rest of the network random."""
    rows = torch.cat([_AXES, -_AXES]).to(drawn[prefix + "fc_p.weight"])
    n = len(rows)
    for name in ("fc_p", "fc_p_img"):
        w = drawn.get(prefix + name + ".weight")
        if w is None:
            continue
        w[:n] = 0.0
        w[:n, :3] = scale * rows
        drawn[prefix + name + ".bias"][:n] = 0.0
    i = 0
    while prefix + f"blocks.{i}.fc_1.weight" in drawn:
        for key in (f"blocks.{i}.fc_1", f"fc_c.{i}"):
            if prefix + key + ".weight" in drawn:
                drawn[prefix + key + ".weight"][:n] = 0.0
                drawn[prefix + key + ".bias"][:n] = 0.0
        i += 1
    head = drawn[prefix + "fc_out.weight"]
    head[:, n:] *= noise
    head[:, :n] = -1.0
