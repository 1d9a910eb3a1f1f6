# Frozen copy of vtaco_tpu_torch/models/conv_onet.py, trimmed to what the benchmark runs and
# kept as its plain reference: it imports nothing of the port and is never
# edited to follow it.
"""Composite convolutional occupancy network (port of
vtaco_tpu/models/conv_onet.py: encode_inputs, encode_hand_inputs,
encode_hand_mano, encode_img_inputs, decode, decode_img).

Submodules keep the reference's names: the object ``encoder``, the hand
encoder ``encoder_hand`` (with the parameter-free ``mano_layer``), the
tactile ``encoder_img``, the nested tactile-to-depth model
``encoder_t2d`` (itself a ConvOccupancyNetwork with a hand encoder and a
depth U-Net) and the ``decoder``; any of them may be None (the tactile
depth stack has no object encoder and no decoder). Images enter in the
JAX package's (B, F, H, W, C) layout. Train and eval behaviour follow the
module's train()/eval() mode.
"""

from __future__ import annotations

import torch
from torch import nn


class ConvOccupancyNetwork(nn.Module):
    def __init__(self, decoder=None, encoder=None, encoder_hand=None,
                 encoder_img=None, encoder_t2d=None, mano_layer=None,
                 hand_out_dim=0):
        super().__init__()
        self.decoder = decoder
        self.encoder = encoder
        self.encoder_hand = encoder_hand
        self.encoder_img = encoder_img
        self.encoder_t2d = encoder_t2d
        self.mano_layer = mano_layer
        self.hand_out_dim = hand_out_dim   # encoder_hand's out_dim (51 runs MANO)

    def encode_inputs(self, inputs):
        """The object's feature fields ({'grid': (B, R, R, R, C)} and/or
        planes (B, R, R, C)) from (B, N, 3) points, or for a crop encoder
        from the dict {"points", "index"}."""
        return self.encoder(inputs)

    def encode_hand_inputs(self, inputs):
        """Hand parameters {'mano_param': (B, out_dim)}, and with the MANO
        layer (out_dim > 30) the hand's vertices, joints and faces in the
        canonical wrist frame: the wrist translation is zeroed and the
        45-dof pose (param[6:]) decoded."""
        fea = self.encoder_hand(inputs)
        if self.hand_out_dim > 30 and self.mano_layer is not None:
            fea_m = fea["mano_param"]
            wrist = fea_m.new_zeros((fea_m.shape[0], 3))
            fea = dict(fea, **self.encode_hand_mano(torch.cat([wrist, fea_m[:, 6:]], 1)))
        return fea

    def encode_hand_mano(self, fea_m_full):
        """The MANO layer on explicit (B, 48) coefficients."""
        mano = self.mano_layer(fea_m_full)
        return {"mano_verts": mano[0], "mano_joints": mano[1],
                "mano_faces": self.mano_layer.faces}

    def encode_img_inputs(self, imgs):
        """Tactile images (B, F, H, W, C) → (B, F, K): K = num_classes per
        finger for ResNet-18, K = H*W (the depth map) for the U-Net."""
        B, Fn = imgs.shape[:2]
        flat = imgs.reshape((B * Fn,) + tuple(imgs.shape[2:])).permute(0, 3, 1, 2)
        return self.encoder_img(flat).reshape(B, Fn, -1)

    def decode(self, p, c):
        """Occupancy logits at (B, N, 3) points (a crop decoder: the dict
        {"p", "p_n"})."""
        return self.decoder(p, c)

    def decode_img(self, p, c, c_img):
        return self.decoder.forward_img(p, c, c_img)
