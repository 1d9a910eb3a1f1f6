"""Composite convolutional occupancy network (port of
vtaco_tpu/models/conv_onet.py: encode_inputs, encode_img_inputs, decode,
decode_img).

Submodules keep the reference's names (``encoder``, ``encoder_img``,
``decoder``). The hand encoder and the nested tactile-to-depth model are
not built in this slice. Images enter in the JAX package's
(B, F, H, W, C) layout.
"""

from __future__ import annotations

from torch import nn


class ConvOccupancyNetwork(nn.Module):
    def __init__(self, decoder=None, encoder=None, encoder_img=None):
        super().__init__()
        self.decoder = decoder
        self.encoder = encoder
        self.encoder_img = encoder_img

    def encode_inputs(self, inputs):
        """Object feature field {'grid': (B, R, R, R, C)} from (B, N, 3)."""
        return self.encoder(inputs)

    def encode_img_inputs(self, imgs):
        """Tactile features: (B, F, H, W, C) images → (B, F, K)."""
        B, Fn = imgs.shape[:2]
        flat = imgs.reshape((B * Fn,) + tuple(imgs.shape[2:])).permute(0, 3, 1, 2)
        return self.encoder_img(flat).reshape(B, Fn, -1)

    def decode(self, p, c):
        return self.decoder(p, c)

    def decode_img(self, p, c, c_img):
        return self.decoder.forward_img(p, c, c_img)
