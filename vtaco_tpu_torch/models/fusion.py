"""Cross-modal attention fusion transformer (port of
vtaco_tpu/models/fusion.py:30-192), the fuser of AttentionDecoder.

As in the JAX package (and the reference it follows):
  * ``RelationUnit`` L2-normalizes its keys and queries (eps 1e-12),
    softmaxes the affinity over the keys, renormalizes it over the queries
    (eps 1e-9) and returns ``relu(trans_conv(query - attention))``.
  * Every layer shares one self-attention module, and the decoder stack
    shares the encoder's: one ``self_attn`` and one ``cross_attn`` serve
    all layers. Each is registered once, where the reference's weight-tied
    clones keep their canonical copy (``encoder.layers.0.self_attn``,
    ``decoder.layers.0.cross_attn``), so the state_dict holds each tensor
    once, under the names core/weights.py gives the JAX tree.
  * InstanceNorm has no affine parameters: a per-(batch, channel)
    normalization over the sequence axis with the biased variance (eps
    1e-5). LayerNorm is flax's (one-pass variance, eps 1e-5).
  * Dropout (0.1) acts only with ``deterministic`` false, and the
    positional embedding's BatchNorm uses batch statistics only with
    ``train``: the caller passes both, as flax's callers do, whatever the
    module's train/eval mode.

Layout (B, N, C) throughout.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vtaco_tpu_torch.models.init import Conv1d, Linear, relation_normal
from vtaco_tpu_torch.models.layers import BatchNorm1d


def _instance_norm(x, eps=1e-5):
    mean = torch.mean(x, dim=1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm: the one-pass variance max(E[x²] - E[x]², 0)."""

    def forward(self, x):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class TransNonlinear(nn.Module):
    """Residual two-layer MLP, then LayerNorm."""

    def __init__(self, d_model, dim_feedforward, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, deterministic=True):
        x = F.dropout(F.relu(self.linear1(src)), self.dropout, not deterministic)
        x = F.dropout(self.linear2(x), self.dropout, not deterministic)
        return self.norm2(src + x)


class RelationUnit(nn.Module):
    """Single-head attention with normalized keys and queries."""

    def __init__(self, feature_dim=512, key_feature_dim=64):
        super().__init__()
        init_k, init_v = relation_normal(key_feature_dim), relation_normal(feature_dim)
        self.WK = Linear(feature_dim, key_feature_dim, bias=False, kernel_init=init_k)
        self.WQ = Linear(feature_dim, key_feature_dim, bias=False, kernel_init=init_k)
        self.WV = Linear(feature_dim, feature_dim, bias=False, kernel_init=init_v)
        self.trans_conv = Linear(feature_dim, feature_dim, bias=False)

    def forward(self, query, key, value):
        w_k = self.WK(key)
        w_k = w_k / (torch.linalg.norm(w_k, dim=-1, keepdim=True) + 1e-12)
        w_q = self.WQ(query)
        w_q = w_q / (torch.linalg.norm(w_q, dim=-1, keepdim=True) + 1e-12)
        affinity = torch.softmax(torch.einsum("bqk,blk->bql", w_q, w_k), dim=-1)
        affinity = affinity / (1e-9 + torch.sum(affinity, dim=1, keepdim=True))
        out = torch.einsum("bql,blc->bqc", affinity, self.WV(value))
        return F.relu(self.trans_conv(query - out))


class MultiheadAttention(nn.Module):
    """RelationUnit heads, each followed by a TransNonlinear, concatenated."""

    def __init__(self, feature_dim=512, n_head=8, key_feature_dim=64,
                 extra_nonlinear=True):
        super().__init__()
        self.head = nn.ModuleList(RelationUnit(feature_dim, key_feature_dim)
                                  for _ in range(n_head))
        self.extra_nonlinear = (nn.ModuleList(
            TransNonlinear(feature_dim, key_feature_dim) for _ in range(n_head))
            if extra_nonlinear else None)

    def forward(self, query, key, value, deterministic=True):
        outs = []
        for n, head in enumerate(self.head):
            h = head(query, key, value)
            if self.extra_nonlinear is not None:
                h = self.extra_nonlinear[n](h, deterministic)
            outs.append(h)
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]


class PositionEmbeddingLearned(nn.Module):
    """Pointwise MLP embedding of coordinates: the reference's
    Sequential(Conv1d, BatchNorm1d, ReLU, Conv1d), applied channel-last."""

    def __init__(self, input_channel=3, num_pos_feats=256):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv1d(input_channel, num_pos_feats, 1), BatchNorm1d(num_pos_feats),
            nn.ReLU(), Conv1d(num_pos_feats, num_pos_feats, 1))

    def forward(self, xyz, train=False):
        conv1, bn, _, conv2 = self.position_embedding_head
        x = F.linear(xyz, conv1.weight[:, :, 0], conv1.bias)
        x = F.relu(bn(x.reshape(-1, x.shape[-1]), train).reshape(x.shape))
        return F.linear(x, conv2.weight[:, :, 0], conv2.bias)


class _Stack(nn.Module):
    """``layers.0`` of one of the reference's stacks: the modules all its
    layers share."""

    def __init__(self, **modules):
        super().__init__()
        layer = nn.Module()
        for name, module in modules.items():
            layer.add_module(name, module)
        self.layers = nn.ModuleList([layer])


class TransformerFusion(nn.Module):
    """``forward(search_feature, search_coord, template_feature,
    template_coord)``: the template stream is self-encoded, then the
    search stream self-attends and cross-attends into it, ``num_layers``
    times each with the shared modules."""

    def __init__(self, d_model=32, num_layers=1, key_feature_dim=128, with_pos_embed=True,
                 encoder_pos_embed_input_dim=3, decoder_pos_embed_input_dim=3):
        super().__init__()
        self.num_layers = num_layers
        self.with_pos_embed = with_pos_embed
        enc = {"self_attn": MultiheadAttention(d_model, 1, key_feature_dim)}
        dec = {"cross_attn": MultiheadAttention(d_model, 1, key_feature_dim)}
        if with_pos_embed:
            enc["self_posembed"] = PositionEmbeddingLearned(
                encoder_pos_embed_input_dim, d_model)
            dec["self_posembed"] = PositionEmbeddingLearned(
                decoder_pos_embed_input_dim, d_model)
        self.encoder = _Stack(**enc)
        self.decoder = _Stack(**dec)

    def forward(self, search_feature, search_coord, template_feature,
                template_coord, deterministic=True, train=False):
        enc, dec = self.encoder.layers[0], self.decoder.layers[0]
        enc_pos = dec_pos = None
        if self.with_pos_embed and template_coord is not None:
            enc_pos = enc.self_posembed(template_coord, train)
            dec_pos = dec.self_posembed(search_coord, train)
        memory = template_feature
        for _ in range(self.num_layers):
            q = memory if enc_pos is None else memory + enc_pos
            memory = F.relu(_instance_norm(memory + enc.self_attn(q, q, q, deterministic)))
        tgt = search_feature
        for _ in range(self.num_layers):
            q = tgt if dec_pos is None else tgt + dec_pos
            tgt = F.relu(_instance_norm(tgt + enc.self_attn(q, q, q, deterministic)))
            mask = dec.cross_attn(tgt, memory, memory, deterministic)
            tgt = F.relu(_instance_norm(tgt + mask))
        return tgt
