"""The Berard LSTM speech-translation baseline (counterpart of s2t_tpu/models/berard.py).

Encoder: linear + tanh input layers over the features, strided 2-D convs
(padding k // 2, channel-major flatten), then bidirectional LSTM layers with
packed semantics: outputs past a row's length are zero and the reverse
direction runs inside each row's own length (berard.py:90-93, :146).  The
LSTMs run as ``torch.lstm`` over a packed sequence (cuDNN on the card), the
JAX package's ``lax.scan`` being outside any Pallas kernel.  A direction's
weights are ``weight_ih`` (4H, D), ``weight_hh`` (4H, H) and one fused
``bias`` (4H): flax's ``kernel_ih`` / ``kernel_hh`` transposed and its
``bias``, handed to torch as ``bias_ih`` beside a zero ``bias_hh``.  Gate order
i, f, g, o, torch's (:63-69).

Decoder: an LSTM step loop with Bahdanau (MLP) attention, a deep output layer
and a projection, mirroring two quirks of the JAX decoder: the initial hidden
state of every layer is the mean of the encoder output over the padded time
axis (:228), and layer i reads the previous state of layer (i - 1) mod L (:238),
so layer 0 reads the previous step's top layer and layer i > 0 this step's
layer i - 1.  Every layer above 0 takes the attention context as its input.

There is no incremental decoder (no ``init_cache`` / ``decode_step``, as in
JAX): the beam generator raises naming ``init_cache``, and the model is served
teacher-forced.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.modules.cast import Conv2d, Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class BerardConfig:
    input_feat_per_channel: int = 80
    input_channels: int = 1
    input_layers: Tuple[int, ...] = (256, 128)
    conv_layers: Tuple[Tuple[int, int, int], ...] = ((16, 3, 2), (16, 3, 2))
    encoder_hidden: int = 256
    encoder_layers: int = 3
    decoder_hidden: int = 512
    decoder_layers: int = 2
    decoder_embed_dim: int = 128
    attention_dim: int = 512
    output_layer_dim: int = 128
    dropout: float = 0.2
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    pad_id: int = 1
    use_ctc: bool = False
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)


class LSTMWeights(nn.Module):
    """One direction's (or one decoder cell's) weights: ``weight_ih`` (4H, D),
    ``weight_hh`` (4H, H), the fused ``bias`` (4H)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def flat(self, dtype) -> list:
        """[w_ih, w_hh, b_ih, b_hh] in ``dtype`` for ``torch.lstm``: b_hh is zero."""
        b = self.bias.to(dtype)
        return [self.weight_ih.to(dtype), self.weight_hh.to(dtype), b, torch.zeros_like(b)]

    def cell(self, x, h, c):
        """One step, gates i, f, g, o: z = x W_ih^T + h W_hh^T + b."""
        z = x @ self.weight_ih.to(x.dtype).t() + h @ self.weight_hh.to(x.dtype).t() + \
            self.bias.to(x.dtype)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class PackedBiLSTM(nn.Module):
    """One bidirectional layer over (B, T, D) with packed semantics; ``fwd`` and
    ``bwd`` are flax's ``blstm{i}_fwd`` / ``blstm{i}_bwd`` (berard.py:72-107)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.fwd = LSTMWeights(in_dim, hidden)
        self.bwd = LSTMWeights(in_dim, hidden)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True, enforce_sorted=False)
        h0 = x.new_zeros((2, B, self.hidden))
        params = self.fwd.flat(x.dtype) + self.bwd.flat(x.dtype)
        # train: cuDNN keeps what its backward reads only when asked
        out, _, _ = torch.lstm(packed.data, packed.batch_sizes, (h0, h0), params, True, 1, 0.0,
                               torch.is_grad_enabled(), True)
        y, _ = pad_packed_sequence(packed._replace(data=out), batch_first=True, total_length=T)
        return y


class BerardEncoder(nn.Module):
    """(features (B, T, F), lengths) -> {"encoder_out" (B, T', 2H), "encoder_lengths", ...}
    (berard.py:110-162)."""

    def __init__(self, cfg: BerardConfig):
        super().__init__()
        self.cfg = cfg
        inputs, d = [], cfg.input_feat_per_channel
        for width in cfg.input_layers:
            inputs.append(Linear(d, width))
            d = width
        self.inputs = nn.ModuleList(inputs)
        convs, ch_in, f = [], 1, d
        for ch, k, s in cfg.conv_layers:
            convs.append(Conv2d(ch_in, ch, k, s, padding=k // 2))
            ch_in, f = ch, (f + 2 * (k // 2) - k) // s + 1
        self.convs = nn.ModuleList(convs)
        blstms, d = [], ch_in * f
        for _ in range(cfg.encoder_layers):
            blstms.append(PackedBiLSTM(d, cfg.encoder_hidden))
            d = 2 * cfg.encoder_hidden
        self.blstms = nn.ModuleList(blstms)

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.cfg
        x = features.to(cfg.dtype)
        for lin in self.inputs:
            x = torch.tanh(dropout(lin(x), cfg.dropout, generator))
        h = x[:, None]  # (B, 1, T, F')
        for conv, (_, k, s) in zip(self.convs, cfg.conv_layers):
            h = conv(h)
            lengths = torch.div(lengths + 2 * (k // 2) - k, s, rounding_mode="floor") + 1
        B, C, T2, F2 = h.shape
        x = h.permute(0, 2, 1, 3).reshape(B, T2, C * F2)
        for i, layer in enumerate(self.blstms):
            x = layer(x, lengths)
            if i < len(self.blstms) - 1:
                x = dropout(x, cfg.dropout, generator)
        x = dropout(x, cfg.dropout, generator)
        return {"encoder_out": x, "encoder_lengths": lengths, "ctc_logits": None,
                "inter_ctc_logits": (), "xctc_logits": None, "inter_xctc_logits": (),
                "mixup": None}


class MLPAttention(nn.Module):
    """Bahdanau attention: softmax over keys of v^T tanh(W_q h + W_k enc + b)
    (berard.py:165-181)."""

    def __init__(self, query_dim: int, key_dim: int, attention_dim: int):
        super().__init__()
        self.encoder_proj = Linear(key_dim, attention_dim)
        self.decoder_proj = Linear(query_dim, attention_dim, bias=False)
        self.to_scores = Linear(attention_dim, 1, bias=False)

    def forward(self, h, enc, keys, enc_mask):
        """``keys``: ``encoder_proj(enc)``, computed once for every step."""
        e = self.to_scores(torch.tanh(self.decoder_proj(h)[:, None, :] + keys))[..., 0]
        a = torch.softmax(e.masked_fill(~enc_mask, float("-inf")), dim=-1)
        return torch.einsum("bt,btd->bd", a, enc)


class LSTMAttentionDecoder(nn.Module):
    """(prev_tokens (B, U), enc, enc_mask) -> logits (B, U, V) (berard.py:184-257)."""

    def __init__(self, cfg: BerardConfig):
        super().__init__()
        self.cfg = cfg
        ctx = 2 * cfg.encoder_hidden
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.decoder_embed_dim)
        self.cells = nn.ModuleList([
            LSTMWeights(cfg.decoder_embed_dim if i == 0 else ctx, cfg.decoder_hidden)
            for i in range(cfg.decoder_layers)])
        self.attention = MLPAttention(cfg.decoder_hidden, ctx, cfg.attention_dim)
        self.deep_output_layer = Linear(cfg.decoder_hidden + ctx + cfg.decoder_embed_dim,
                                        cfg.output_layer_dim)
        self.output_projection = Linear(cfg.output_layer_dim, cfg.vocab_size)

    def forward(self, prev_tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        cfg = self.cfg
        B, U = prev_tokens.shape
        L = cfg.decoder_layers
        emb = self.embed_tokens(prev_tokens).to(cfg.dtype)
        x = dropout(emb, cfg.dropout, generator)
        keys = self.attention.encoder_proj(enc)
        # every layer starts from the mean over the padded time axis (berard.py:228)
        hiddens = [enc.mean(dim=1).to(cfg.dtype)] * L
        cells = [enc.new_zeros((B, cfg.decoder_hidden), dtype=cfg.dtype)] * L
        tops, ctxs = [], []
        for j in range(U):
            inp, context = x[:, j], None
            for i, cell in enumerate(self.cells):
                h, c = cell.cell(inp, hiddens[(i - 1) % L], cells[(i - 1) % L])
                hiddens[i], cells[i] = dropout(h, cfg.dropout, generator), c
                if context is None:
                    context = dropout(self.attention(hiddens[i], enc, keys, enc_mask),
                                      cfg.dropout, generator)
                    ctxs.append(context)
                inp = context
            tops.append(hiddens[L - 1])
        y = torch.cat([torch.stack(tops, dim=1), torch.stack(ctxs, dim=1), emb], dim=-1)
        y = dropout(torch.tanh(self.deep_output_layer(y)), cfg.dropout, generator)
        return self.output_projection(y)


@register_model("berard")
class BerardModel(nn.Module):
    """``forward(features, feat_lengths, prev_tokens, train, generator)`` ->
    {"decoder_logits", **the encoder's outputs}; ``encode``.  Weights from
    ``seed``; serving (frozen, stored in ``cfg.dtype``) or ``for_training``
    (float32 masters)."""

    @seeded_init
    def __init__(self, cfg: BerardConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = BerardEncoder(cfg)
        self.decoder = LSTMAttentionDecoder(cfg)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def forward(self, features, feat_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        enc = self.encoder(features, feat_lengths, generator)
        mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        logits = self.decoder(prev_tokens, enc["encoder_out"], mask, generator)
        return {"decoder_logits": logits, **enc}

    def encode(self, features, feat_lengths):
        return self.encoder(features, feat_lengths)


@register_model_architecture("berard", "berard")
@register_model_architecture("berard", "s2t_berard")
def berard_base(**kw) -> BerardConfig:
    """The arXiv:1802.04200 original."""
    return BerardConfig().replace(**kw)


@register_model_architecture("berard", "s2t_berard_256_3_3")
def berard_256_3_3(**kw) -> BerardConfig:
    """CoVoST's baseline: 3 decoder layers."""
    return BerardConfig(decoder_layers=3).replace(**kw)


@register_model_architecture("berard", "berard_512_3_2")
@register_model_architecture("berard", "s2t_berard_512_3_2")
def berard_512_3_2(**kw) -> BerardConfig:
    return BerardConfig(
        encoder_hidden=512, dropout=0.3, decoder_embed_dim=256, decoder_layers=2,
        decoder_hidden=1024, attention_dim=512, output_layer_dim=256,
    ).replace(**kw)


@register_model_architecture("berard", "s2t_berard_512_5_3")
def berard_512_5_3(**kw) -> BerardConfig:
    return BerardConfig(
        encoder_layers=5, encoder_hidden=512, dropout=0.3, decoder_embed_dim=256,
        decoder_layers=3, decoder_hidden=1024, attention_dim=512, output_layer_dim=256,
    ).replace(**kw)
