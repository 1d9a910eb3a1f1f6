"""Bars and planted faults shared by the bfloat16 checks of the ``*_fast``
configs: the CPU tests (tests/test_torch_fast_modules.py), the card test of
a bfloat16 step (tests/test_torch_cuda.py) and chip_smoke.py's fast phase.
It imports torch only.

Step bars. A bfloat16 train step on the card is held against the card's
float32 ('highest') step from the same weights, batch and draws, to twice
the JAX package's own gap between the two. The gaps below were measured on
the CPU at small widths and random weights (seeds 21-23; `JAX_PLATFORMS=cpu
PYTHONPATH=.:tests python tests/test_torch_fast_trained.py`, train_steps 0,
reference 'faithful': the JAX step compiled with XLA's excess precision
off, as PyTorch rounds every operation): the largest relative gap of a
loss scalar, and each module's relative gradient distance pooled over the
three weight sets, each beside the least and the largest of the three
sets' readings. Where JAX's own distance nears 1 (the object encoder,
ResNet-18, the tactile U-Net: the step's rounding scrambles their
gradients) the step bar holds little, and the module check holds them.

Module bars. A module alone (train mode, its parameters and inputs cast
as the step casts them, a fixed cotangent) is compared against a reference
bfloat16 evaluation in units of the reference's bfloat16-to-float32 gap:
R <= MODULE_OUT_BAR for each output, R <= MODULE_GRAD_BAR for the
gradient, against the JAX package's on the CPU, where the planted faults
must fail them (the module left in float32; BatchNorm reducing in
bfloat16, bf16_batchnorm). On the card the reference is the port's
bfloat16 evaluation on the host CPU, whose kernels round otherwise than
the card's: R <= CARD_BAR for the gradient and for each output, but for
the outputs of CARD_OUTPUTS_LOGGED. At the built weights, on an H100
80GB HBM3 at 700 W (chip_smoke.py, PERF.md), the port read at most 0.446
on an output and 0.587 on a gradient (both ResNet-18's), the planted
faults at least 0.884 and 0.955. The hand encoders' outputs read
0.85-0.97 there (0.24-0.77 at trained weights), as far as their float32
fault (1.0): the card's and the CPU's bfloat16 evaluations of them part
by about the whole bfloat16 gap, so they are logged and only the hand
encoders' gradients (0.25-0.27) are held.
"""

import torch

# config → (largest relative loss-scalar gap; the least and the largest of
# the three weight sets' largest gaps)
JAX_LOSS_GAP = {"vtaco": (0.07805, 0.007209, 0.07805),
                "vtacoh": (0.08714, 0.007209, 0.08714),
                "tactile": (0.001007, 0.0001057, 0.001007)}
# config → {module: (pooled relative gradient distance; least, largest)}
JAX_GRAD_REL = {"vtaco": {"decoder": (0.2074, 0.1579, 0.6396),
                          "encoder": (0.8298, 0.7448, 1.39),
                          "encoder_hand": (0.06441, 0.04927, 0.1189),
                          "encoder_img": (0.8056, 0.6542, 1.175)},
                "vtacoh": {"decoder": (0.1304, 0.08917, 0.2534),
                           "encoder": (0.8258, 0.7456, 0.9173),
                           "encoder_hand": (0.06441, 0.04927, 0.1189),
                           "encoder_img": (1.084, 0.4348, 2.07)},
                "tactile": {"encoder_hand": (0.05652, 0.0533, 0.1017),
                            "encoder_img": (0.4556, 0.4479, 0.4598)}}
# config → JAX's gaps at trained full-width weights: the shipped widths,
# 19 float32 JAX steps from each of seeds 21-23 on a 320x240 synthetic set,
# excess precision off (`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/test_torch_fast_trained.py --full-width --configs tactile`): the root
# mean square and the largest of the loss scalars' relative gaps, and each
# module's pooled relative gradient distance. tests/f5_card.py holds the
# card's step at the same weights to twice these (F5, ROADMAP.md §3).
JAX_TRAINED_FULL_WIDTH = {
    "tactile": {"loss_rms": 0.0010544066889218696, "loss_max": 0.0018424731736895537,
                "grad_rel": {"encoder_hand": 0.048714315624631466,
                             "encoder_img": 0.3594212475102306}}}
MODULE_OUT_BAR, MODULE_GRAD_BAR = 0.6, 0.8
CARD_BAR = 0.8
CARD_OUTPUTS_LOGGED = ("encoder_hand",)


def step_bars(name):
    """(largest relative loss-scalar gap, {module: largest relative
    gradient distance}) that a bfloat16 step of config ``name`` may show
    against its float32 step: twice the JAX package's."""
    return (2 * JAX_LOSS_GAP[name][0],
            {m: 2 * v[0] for m, v in JAX_GRAD_REL[name].items()})


def trained_bars(name):
    """Twice JAX_TRAINED_FULL_WIDTH[name]: the bars of a bfloat16 step at
    those trained weights (None where JAX's gap was not measured)."""
    ref = JAX_TRAINED_FULL_WIDTH.get(name)
    if ref is None:
        return None
    return {"loss_rms": 2 * ref["loss_rms"], "loss_max": 2 * ref["loss_max"],
            "grad_rel": {m: 2 * v for m, v in ref["grad_rel"].items()}}


def bf16_batchnorm(self, x):
    """A planted fault for models.layers.BatchNorm2d.forward: train-mode
    statistics and normalization in the input's dtype (bfloat16)."""
    if not self.training:
        raise AssertionError("bf16_batchnorm plants a train-mode fault")
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        self.running_mean.lerp_(mean.float(), self.momentum)
        self.running_var.lerp_(var.float(), self.momentum)
        self.num_batches_tracked += 1
    mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
    return (x - mean[:, None, None]) * mul[:, None, None] + self.bias.to(x.dtype)[:, None, None]


def exact_zero(names):
    """Parameter names of convolution biases that feed their block's
    train-mode BatchNorm ``bn`` (the tactile U-Net's conv1 and conv2): the
    norm removes any per-channel constant, so their exact gradient is zero
    and a step's is rounding. Gradient comparisons leave them out."""
    names = set(names)
    return {n for n in names if n.endswith(".bias") and n.split(".")[-2].startswith("conv")
            and n.rsplit(".", 2)[0] + ".bn.weight" in names}
