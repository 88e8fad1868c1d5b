"""Analytic model-FLOP accounting for MFU (the port's copy of s2t_tpu/utils/flops.py).

MFU is defined on the DENSE-FORMULATION flops the model semantically
requires (matmuls/convs of the architecture, backward counted as 2x
forward) — NOT on the flops the compiled program happens to execute.
Counting executed flops penalizes optimizations that remove redundant
work (e.g. the chunked CTC normalizer eliminating the logits tensor
also deletes its cost-analysis flops) and rewards remat (recompute
inflates executed flops).  This is the convention of the scaling
literature ("model FLOPs utilization").

Only matmul-class terms are counted; elementwise work is excluded.
"""

from __future__ import annotations


def conv1d_flops(B: int, T_out: int, C_in: int, C_out: int, k: int) -> float:
    return 2.0 * B * T_out * C_out * k * C_in


def attention_flops(B: int, T_q: int, T_kv: int, D: int,
                    proj_q: int = 2, proj_kv: int = 2) -> float:
    """Projections (q+out / k+v over their own lengths) + scores + AV."""
    proj = 2.0 * B * (proj_q * T_q + proj_kv * T_kv) * D * D
    core = 2.0 * B * T_q * T_kv * D * 2  # QK^T and PV
    return proj + core


def s2t_train_flops(
    B: int,
    T_frames: int,
    U: int,
    *,
    d_model: int,
    ffn: int,
    enc_layers: int,
    dec_layers: int,
    vocab: int,
    feat_dim: int = 80,
    subsample_filters: int = 1024,
    subsample_kernel: int = 5,
    subsample_glu: bool = True,
    use_ctc: bool = True,
    fwd_bwd: bool = True,
) -> float:
    """Dense-formulation train-step flops for the s2t_transformer family
    (reference architecture: s2t_transformer.py presets).  Backward = 2x
    forward when ``fwd_bwd``."""
    g = 2 if subsample_glu else 1
    T1 = (T_frames - 1) // 2 + 1
    T2 = (T1 - 1) // 2 + 1
    f = conv1d_flops(B, T1, feat_dim, subsample_filters * g, subsample_kernel)
    f += conv1d_flops(B, T2, subsample_filters, d_model * g, subsample_kernel)
    Tp = T2
    per_enc = (
        attention_flops(B, Tp, Tp, d_model)
        + 2.0 * 2 * B * Tp * d_model * ffn
    )
    f += enc_layers * per_enc
    per_dec = (
        attention_flops(B, U, U, d_model)             # self
        + attention_flops(B, U, Tp, d_model)          # cross
        + 2.0 * 2 * B * U * d_model * ffn
    )
    f += dec_layers * per_dec
    if use_ctc:
        f += 2.0 * B * Tp * d_model * vocab
    f += 2.0 * B * U * d_model * vocab  # decoder output projection
    return 3.0 * f if fwd_bwd else f
