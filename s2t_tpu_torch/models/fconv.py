"""Fully convolutional seq2seq, ConvS2S (counterpart of s2t_tpu/models/fconv.py).

The design is the JAX model's: no weight normalisation, and every convolution
is a window unfold followed by one ``Linear`` per layer, ((B, T, k C) @ (k C, 2C))
-> GLU, whose weight rows are in window order (tap 0's C channels, then tap 1's;
``unfold_same`` / ``unfold_causal``, fconv.py:37-48).  The same ``Linear`` drives
incremental decoding, where the cache holds each decoder layer's last k - 1
inputs (``conv{i}``: (N, k - 1, C_in), width 0 where k = 1), so the beam reorders
those windows whole (``inference/beam_search.py``).

Positions are learned embeddings of the plain indices ``arange(T)``; residuals
and the attention's output are scaled by sqrt(0.5); the attended context is
rescaled by sqrt(number of valid source tokens) (fconv.py:193-203); a residual
projection ``res{i}`` exists only where the channel count changes.  The encoder
returns its output and the attention values packed as one (B, T, 2E)
``encoder_out``, which the decoder splits.  Token and position tables start from
N(0, 0.1), as JAX's.  Plain PyTorch: no TPU kernel runs here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.registry import register_model, register_model_architecture

SQRT_HALF = 0.7071067811865476
EMBED_STD = 0.1  # flax normal(0.1) of fconv's token and position tables


def unfold_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, C) -> (B, T, k C) centred windows (SAME padding)."""
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))
    return torch.cat([xp[:, i:i + x.shape[1]] for i in range(k)], dim=-1)


def unfold_causal(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, C) -> (B, T, k C) windows ending at t (left pad k - 1)."""
    xp = F.pad(x, (0, 0, k - 1, 0))
    return torch.cat([xp[:, i:i + x.shape[1]] for i in range(k)], dim=-1)


@dataclass(frozen=True)
class FConvConfig:
    encoder_embed_dim: int = 512
    encoder_convs: Tuple[Tuple[int, int], ...] = ((512, 3),) * 20  # (channels, k)
    decoder_embed_dim: int = 512
    decoder_convs: Tuple[Tuple[int, int], ...] = ((512, 3),) * 20
    decoder_out_embed_dim: int = 256
    dropout: float = 0.1
    share_decoder_input_output_embed: bool = False
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 1024
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"
    # the generator's length bound reads these
    subsampling_layers: int = 0
    subsampling_stride: int = 1
    decoder_layers: int = 1  # nonzero: the task builds a SequenceGenerator

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def src_vocab(self) -> int:
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size


def _embedding(n: int, dim: int) -> nn.Embedding:
    emb = nn.Embedding(n, dim)
    emb.init_std = EMBED_STD
    return emb


class _ConvStack(nn.Module):
    """fc1, the GLU convolutions ``convs.{i}`` and their residual projections
    ``ress.{i}`` (only where the channel count changes)."""

    def __init__(self, embed_dim: int, convs: Tuple[Tuple[int, int], ...]):
        super().__init__()
        chans = [c for c, _ in convs]
        self.fc1 = Linear(embed_dim, chans[0])
        self.convs = nn.ModuleList([Linear(k * (chans[i - 1] if i else chans[0]), 2 * c)
                                    for i, (c, k) in enumerate(convs)])
        self.ress = nn.ModuleDict({str(i): Linear(chans[i - 1], c)
                                   for i, (c, _) in enumerate(convs) if i and chans[i - 1] != c})

    def residual(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.ress[str(i)](x) if str(i) in self.ress else x


class FConvEncoder(_ConvStack):
    def __init__(self, cfg: FConvConfig):
        super().__init__(cfg.encoder_embed_dim, cfg.encoder_convs)
        self.cfg = cfg
        E = cfg.encoder_embed_dim
        self.embed_tokens = _embedding(cfg.src_vocab, E)
        self.embed_positions = _embedding(cfg.max_source_positions, E)
        self.fc2 = Linear(cfg.encoder_convs[-1][0], E)

    def forward(self, src_tokens: torch.Tensor, src_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.cfg
        if src_lengths is None:
            src_lengths = (src_tokens != cfg.pad_id).sum(dim=1)
        T = src_tokens.shape[1]
        pos = torch.arange(T, device=src_tokens.device)
        emb = (self.embed_tokens(src_tokens).to(cfg.dtype)
               + self.embed_positions(pos).to(cfg.dtype)[None])
        emb = dropout(emb, cfg.dropout, generator)
        valid = (src_tokens != cfg.pad_id)[..., None]
        x = self.fc1(emb)
        for i, (_, k) in enumerate(cfg.encoder_convs):
            residual = self.residual(i, x)
            x = torch.where(valid, x, 0.0)  # zero pads so windows stay clean
            x = dropout(x, cfg.dropout, generator)
            x = F.glu(self.convs[i](unfold_same(x, k)), dim=-1)
            x = (x + residual) * SQRT_HALF
        y = self.fc2(x)
        value = (y + emb) * SQRT_HALF
        return {"encoder_out": torch.cat([y, value], dim=-1), "encoder_lengths": src_lengths,
                "ctc_logits": None, "inter_ctc_logits": (), "xctc_logits": None,
                "inter_xctc_logits": (), "mixup": None}


class FConvDecoder(_ConvStack):
    def __init__(self, cfg: FConvConfig):
        super().__init__(cfg.decoder_embed_dim, cfg.decoder_convs)
        self.cfg = cfg
        E = cfg.decoder_embed_dim
        if cfg.share_decoder_input_output_embed and cfg.decoder_out_embed_dim != E:
            raise ValueError("share_decoder_input_output_embed requires decoder_out_embed_dim "
                             f"== decoder_embed_dim ({cfg.decoder_out_embed_dim} != {E})")
        self.embed_tokens = _embedding(cfg.vocab_size, E)
        self.embed_positions = _embedding(cfg.max_target_positions, E)
        self.attn_qs = nn.ModuleList([Linear(c, cfg.encoder_embed_dim)
                                      for c, _ in cfg.decoder_convs])
        self.attn_os = nn.ModuleList([Linear(cfg.encoder_embed_dim, c)
                                      for c, _ in cfg.decoder_convs])
        self.fc2 = Linear(cfg.decoder_convs[-1][0], cfg.decoder_out_embed_dim)
        self.fc3 = (None if cfg.share_decoder_input_output_embed
                    else Linear(cfg.decoder_out_embed_dim, cfg.vocab_size))

    def _attend(self, i, x, target_emb, enc_y, enc_value, enc_valid):
        """Layer i's multi-step attention (fconv.py:185-203); x (B, U, C)."""
        q = (self.attn_qs[i](x) + target_emb) * SQRT_HALF
        scores = torch.einsum("bue,bte->but", q, enc_y).float()
        scores = scores.masked_fill(~enc_valid[:, None, :], -1e9)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("but,bte->bue", attn, enc_value)
        s = enc_valid.sum(dim=-1).to(ctx.dtype)[:, None, None]
        ctx = ctx * torch.sqrt(torch.clamp(s, min=1.0))
        return (self.attn_os[i](ctx) + x) * SQRT_HALF

    def _split_enc(self, encoder_out):
        E = self.cfg.encoder_embed_dim
        return encoder_out[..., :E], encoder_out[..., E:]

    def _output(self, x):
        if self.fc3 is None:
            return x @ self.embed_tokens.weight.to(x.dtype).t()
        return self.fc3(x)

    def _embed(self, tokens, positions):
        dt = self.cfg.dtype
        return self.embed_tokens(tokens).to(dt) + self.embed_positions(positions).to(dt)[None]

    def forward(self, prev_tokens, encoder_out, encoder_valid_mask,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        enc_y, enc_value = self._split_enc(encoder_out)
        emb = self._embed(prev_tokens, torch.arange(prev_tokens.shape[1],
                                                    device=prev_tokens.device))
        emb = dropout(emb, cfg.dropout, generator)
        x = self.fc1(emb)
        for i, (_, k) in enumerate(cfg.decoder_convs):
            residual = self.residual(i, x)
            x = dropout(x, cfg.dropout, generator)
            x = F.glu(self.convs[i](unfold_causal(x, k)), dim=-1)
            x = self._attend(i, x, emb, enc_y, enc_value, encoder_valid_mask)
            x = (x + residual) * SQRT_HALF
        x = dropout(self.fc2(x), cfg.dropout, generator)
        return self._output(x)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """Layer i's rolling window of its last k - 1 inputs (N, k - 1, C_in)."""
        chans = [c for c, _ in self.cfg.decoder_convs]
        ref = self.fc1.weight
        dtype = self.cfg.dtype
        return {f"conv{i}": torch.zeros((batch_size, k - 1, chans[i - 1] if i else chans[0]),
                                        dtype=dtype, device=ref.device)
                for i, (_, k) in enumerate(self.cfg.decoder_convs)}

    def step(self, tokens, cache: dict, index: int, encoder_out, encoder_valid_mask):
        """(N, 1) tokens at position ``index`` -> ((N, V) logits, cache); the
        windows are replaced in the cache dict."""
        enc_y, enc_value = self._split_enc(encoder_out)
        emb = self._embed(tokens, torch.full((1,), int(index), dtype=torch.long,
                                             device=tokens.device))
        x = self.fc1(emb)
        for i, _ in enumerate(self.cfg.decoder_convs):
            residual = self.residual(i, x)
            window = torch.cat([cache[f"conv{i}"], x], dim=1)  # (N, k, C_in)
            cache[f"conv{i}"] = window[:, 1:]
            x = F.glu(self.convs[i](window.reshape(window.shape[0], 1, -1)), dim=-1)
            x = self._attend(i, x, emb, enc_y, enc_value, encoder_valid_mask)
            x = (x + residual) * SQRT_HALF
        return self._output(self.fc2(x))[:, 0], cache


@register_model("fconv")
class FConvModel(nn.Module):
    """``forward(src_tokens, src_lengths, prev_tokens, train, generator)`` ->
    {"decoder_logits", **the encoder's outputs}, with the generator's surface
    (``encode``, ``decode_step``, ``init_cache``)."""

    kv_int8_cache = False

    @seeded_init
    def __init__(self, cfg: FConvConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = FConvEncoder(cfg)
        self.decoder = FConvDecoder(cfg)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.fc1.weight.device

    def forward(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        enc = self.encoder(src_tokens, src_lengths, generator)
        logits = self.decoder(prev_tokens, enc["encoder_out"], src_tokens != self.cfg.pad_id,
                              generator)
        return {"decoder_logits": logits, **enc}

    def encode(self, src_tokens, src_lengths):
        return self.encoder(src_tokens, src_lengths)

    def decode(self, prev_tokens, encoder_out, encoder_valid_mask):
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, **unused):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask)

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False):
        return self.decoder.init_cache(batch_size, max_len)


@register_model_architecture("fconv", "fconv")
def fconv_base(**kw) -> FConvConfig:
    return FConvConfig().replace(**kw)


@register_model_architecture("fconv", "fconv_iwslt_de_en")
def fconv_iwslt(**kw) -> FConvConfig:
    return FConvConfig(
        encoder_embed_dim=256, encoder_convs=((256, 3),) * 4,
        decoder_embed_dim=256, decoder_convs=((256, 3),) * 3,
        decoder_out_embed_dim=256,
    ).replace(**kw)


@register_model_architecture("fconv", "fconv_wmt_en_de")
def fconv_wmt_en_de(**kw) -> FConvConfig:
    convs = ((512, 3),) * 9 + ((1024, 3),) * 4 + ((2048, 1),) * 2
    return FConvConfig(
        encoder_embed_dim=768, encoder_convs=convs,
        decoder_embed_dim=768, decoder_convs=convs,
        decoder_out_embed_dim=512,
    ).replace(**kw)
