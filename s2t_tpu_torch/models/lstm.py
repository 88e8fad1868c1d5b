"""The LSTM encoder-decoder and the LSTM language model (counterpart of
s2t_tpu/models/lstm.py).

``LSTMModel``: token embeddings (N(0, 0.1)), dropout, padded positions zeroed,
then ``encoder_layers`` LSTM layers, bidirectional by default, each run as
``torch.lstm`` over the packed rows (cuDNN on the card): the reverse direction
runs inside each row's own length, which is what JAX's ``reverse_padded`` gives,
and the outputs past a row's length are zero.  A projection to the decoder's
width where the two differ.  The decoder is Luong's input-feeding loop, one step
a target position: [token embedding | the previous step's output] through
``decoder_layers`` LSTM cells, general attention (``attn_proj`` of the top state
against the encoder output, padded keys at -1e30, the softmax in float32), then
tanh(``out_proj`` [state | context]) after dropout is both this step's output and
the next step's input feed; the logits are the output against the target table
(``share_decoder_input_output_embed``, which needs the decoder's hidden width equal
to its embedding width, as in JAX) or ``logits_proj``.  ``init_cache`` /
``decode_step`` carry each layer's (``h{i}``, ``c{i}``) and the ``feed`` for the
beam.  No kernel of the Pallas set: JAX's recurrences are ``lax.scan``s.

``LSTMLM``: the decoder-only language model, ``decoder_layers`` LSTMs over the
whole block (no packing: an LM block has no padding), dropout, then the tied
table (through ``out_to_emb`` where the hidden width differs) or ``logits_proj``.

Flax keeps an ``OptimizedLSTMCell``'s weights as one Dense a gate (``ii`` ...
``io`` over the input, ``hi`` ... ``ho`` with the bias over the state); the port
keeps Berard's ``weight_ih`` (4H, D), ``weight_hh`` (4H, H) and one ``bias`` (4H)
in the gate order i, f, g, o, and ``interop/from_flax.py`` fuses and splits them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.berard import LSTMWeights
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask

EMBED_STD = 0.1  # flax normal(0.1) for both tables


@dataclass(frozen=True)
class LSTMConfig:
    encoder_embed_dim: int = 512
    encoder_hidden_size: int = 512
    encoder_layers: int = 1
    encoder_bidirectional: bool = True
    decoder_embed_dim: int = 512
    decoder_hidden_size: int = 512
    decoder_layers: int = 1
    dropout: float = 0.1
    share_decoder_input_output_embed: bool = True
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 1024
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"
    # the generator's length bound reads these (no subsampling over tokens)
    subsampling_layers: int = 0
    subsampling_stride: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def src_vocab(self) -> int:
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size


def embedding(n: int, dim: int) -> nn.Embedding:
    emb = nn.Embedding(n, dim)
    emb.init_std = EMBED_STD
    return emb


def run_lstm(x: torch.Tensor, directions: List[LSTMWeights], hidden: int,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One LSTM layer (one direction, or forward and reverse) over (B, T, D) as
    ``torch.lstm``; with ``lengths`` over the packed rows (a 0-length row runs one
    step and is zeroed by the caller)."""
    B, T, _ = x.shape
    h0 = x.new_zeros((len(directions), B, hidden))
    params = [w for d in directions for w in d.flat(x.dtype)]
    bidirectional = len(directions) == 2
    # train: cuDNN keeps what its backward reads only when asked
    train = torch.is_grad_enabled()
    if lengths is None:
        return torch.lstm(x, (h0, h0), params, True, 1, 0.0, train, bidirectional, True)[0]
    packed = pack_padded_sequence(x, lengths.clamp(min=1).cpu(), batch_first=True,
                                  enforce_sorted=False)
    out, _, _ = torch.lstm(packed.data, packed.batch_sizes, (h0, h0), params, True, 1, 0.0,
                           train, bidirectional)
    return pad_packed_sequence(packed._replace(data=out), batch_first=True, total_length=T)[0]


def _state_cache(states, feed=None) -> dict:
    cache = {}
    for i, (h, c) in enumerate(states):
        cache[f"h{i}"], cache[f"c{i}"] = h, c
    if feed is not None:
        cache["feed"] = feed
    return cache


@register_model("lstm")
class LSTMModel(nn.Module):
    kv_int8_cache = False

    @seeded_init
    def __init__(self, cfg: LSTMConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        H, Hd = cfg.encoder_hidden_size, cfg.decoder_hidden_size
        self.src_embed = embedding(cfg.src_vocab, cfg.encoder_embed_dim)
        self.tgt_embed = embedding(cfg.vocab_size, cfg.decoder_embed_dim)
        n_dir = 2 if cfg.encoder_bidirectional else 1
        dims = [cfg.encoder_embed_dim] + [n_dir * H] * (cfg.encoder_layers - 1)
        self.enc_fws = nn.ModuleList([LSTMWeights(d, H) for d in dims])
        self.enc_bws = nn.ModuleList([LSTMWeights(d, H) for d in dims]
                                     if cfg.encoder_bidirectional else [])
        self.enc_proj = Linear(n_dir * H, Hd) if n_dir * H != Hd else None
        self.decs = nn.ModuleList([LSTMWeights(cfg.decoder_embed_dim + Hd if i == 0 else Hd, Hd)
                                   for i in range(cfg.decoder_layers)])
        self.attn_proj = Linear(Hd, Hd, bias=False)
        self.out_proj = Linear(2 * Hd, Hd)
        self.logits_proj = (None if cfg.share_decoder_input_output_embed
                            else Linear(Hd, cfg.vocab_size, bias=False))
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.weight.device

    def encode(self, src_tokens, src_lengths=None,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.cfg
        if src_lengths is None:
            src_lengths = (src_tokens != cfg.pad_id).sum(dim=1)
        src_lengths = torch.as_tensor(src_lengths, device=src_tokens.device)
        x = dropout(self.src_embed(src_tokens).to(cfg.dtype), cfg.dropout, generator)
        valid = lengths_to_mask(src_lengths, x.shape[1])[..., None]
        x = x.masked_fill(~valid, 0.0)
        for i, fw in enumerate(self.enc_fws):
            dirs = [fw, self.enc_bws[i]] if cfg.encoder_bidirectional else [fw]
            x = run_lstm(x, dirs, cfg.encoder_hidden_size, src_lengths)
        if self.enc_proj is not None:
            x = self.enc_proj(x)
        x = x.masked_fill(~valid, 0.0)
        return {"encoder_out": x, "encoder_lengths": src_lengths, "ctc_logits": None,
                "inter_ctc_logits": (), "xctc_logits": None, "inter_xctc_logits": (),
                "mixup": None}

    def _attend(self, h, enc_out, enc_valid):
        scores = torch.einsum("bd,btd->bt", self.attn_proj(h), enc_out)
        scores = scores.masked_fill(~enc_valid, -1e30)
        w = torch.softmax(scores.float(), dim=-1).to(h.dtype)
        return torch.einsum("bt,btd->bd", w, enc_out)

    def _dec_step(self, emb, states, feed, enc_out, enc_valid, generator=None):
        """One input-feeding step: (output, the layers' new (h, c)); the output is
        also the next step's feed."""
        x = torch.cat([emb, feed], dim=-1)
        new_states = []
        for cell, (h, c) in zip(self.decs, states):
            x, c = cell.cell(x, h, c)
            new_states.append((x, c))
        out = torch.tanh(self.out_proj(torch.cat([x, self._attend(x, enc_out, enc_valid)], -1)))
        return dropout(out, self.cfg.dropout, generator), new_states

    def _logits(self, out):
        if self.logits_proj is None:
            return out @ self.tgt_embed.weight.to(out.dtype).t()
        return self.logits_proj(out)

    def _zeros(self, n: int, ref: torch.Tensor):
        return ref.new_zeros((n, self.cfg.decoder_hidden_size))

    def forward(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        enc = self.encode(src_tokens, src_lengths, generator)
        enc_out = enc["encoder_out"]
        enc_valid = lengths_to_mask(enc["encoder_lengths"], enc_out.shape[1])
        emb = dropout(self.tgt_embed(prev_tokens).to(self.cfg.dtype), self.cfg.dropout,
                      generator)
        B = prev_tokens.shape[0]
        states = [(self._zeros(B, emb), self._zeros(B, emb)) for _ in self.decs]
        feed, outs = self._zeros(B, emb), []
        for t in range(prev_tokens.shape[1]):
            feed, states = self._dec_step(emb[:, t], states, feed, enc_out, enc_valid, generator)
            outs.append(feed)
        return {"decoder_logits": self._logits(torch.stack(outs, dim=1)), **enc}

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False) -> dict:
        ref = self.tgt_embed.weight.to(self.cfg.dtype)
        z = self._zeros(batch_size, ref)
        return _state_cache([(z, z) for _ in self.decs], z)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, **unused):
        """(N, 1) tokens -> ((N, V) logits, cache); the states are replaced in the dict."""
        emb = self.tgt_embed(tokens[:, 0]).to(self.cfg.dtype)
        states = [(cache[f"h{i}"], cache[f"c{i}"]) for i in range(len(self.decs))]
        out, states = self._dec_step(emb, states, cache["feed"], encoder_out, encoder_valid_mask)
        cache.update(_state_cache(states, out))
        return self._logits(out), cache


@register_model_architecture("lstm", "lstm")
@register_model_architecture("lstm", "lstm_wiseman_iwslt_de_en")
def lstm_iwslt(**kw) -> LSTMConfig:
    return LSTMConfig(encoder_embed_dim=256, encoder_hidden_size=256, decoder_embed_dim=256,
                      decoder_hidden_size=256).replace(**kw)


@register_model("lstm_lm")
class LSTMLM(nn.Module):
    """``forward(prev_tokens, ..., generator)`` -> {"decoder_logits"}, with
    ``init_cache`` / ``decode_step`` for the generator's LM fusion."""

    @seeded_init
    def __init__(self, cfg: LSTMConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.decoder_embed_dim, cfg.decoder_hidden_size
        self.tgt_embed = embedding(cfg.vocab_size, E)
        self.lstms = nn.ModuleList([LSTMWeights(E if i == 0 else H, H)
                                    for i in range(cfg.decoder_layers)])
        share = cfg.share_decoder_input_output_embed
        self.out_to_emb = Linear(H, E) if share and H != E else None
        self.logits_proj = None if share else Linear(H, cfg.vocab_size, bias=False)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.weight.device

    def _logits(self, out):
        if self.logits_proj is not None:
            return self.logits_proj(out)
        if self.out_to_emb is not None:
            out = self.out_to_emb(out)
        return out @ self.tgt_embed.weight.to(out.dtype).t()

    def forward(self, prev_tokens, targets=None, generator: Optional[torch.Generator] = None,
                **unused) -> Dict[str, Any]:
        p = self.cfg.dropout
        x = dropout(self.tgt_embed(prev_tokens).to(self.cfg.dtype), p, generator)
        for cell in self.lstms:
            x = run_lstm(x, [cell], self.cfg.decoder_hidden_size)
        return {"decoder_logits": self._logits(dropout(x, p, generator))}

    def init_cache(self, batch_size: int, max_len: int, **unused) -> dict:
        z = self.tgt_embed.weight.new_zeros((batch_size, self.cfg.decoder_hidden_size),
                                            dtype=self.cfg.dtype)
        return _state_cache([(z, z) for _ in self.lstms])

    def decode_step(self, tokens, cache, index) -> Tuple[torch.Tensor, dict]:
        x = self.tgt_embed(tokens[:, 0]).to(self.cfg.dtype)
        states = []
        for i, cell in enumerate(self.lstms):
            x, c = cell.cell(x, cache[f"h{i}"], cache[f"c{i}"])
            states.append((x, c))
        cache.update(_state_cache(states))
        return self._logits(x), cache


@register_model_architecture("lstm_lm", "lstm_lm")
def lstm_lm(**kw) -> LSTMConfig:
    return LSTMConfig(encoder_bidirectional=False, decoder_layers=1).replace(**kw)
