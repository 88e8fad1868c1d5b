"""Model construction from an arch name and config-dict overrides
(counterpart of s2t_tpu/models/build.py).

The ported presets are the ``s2t_transformer`` ones whose features the port
has (base, s, xs, sp, m, mp, l, lp), the 13 ``pdss2t_transformer_*`` ones
and the encoder-only ``s2t_ctc`` and ``s2t_ctc_pds``.  The presets that need
modules the port does not have yet raise ``NotImplementedError`` naming the
arch; a ported preset whose config selects an unported branch raises naming
the field.
"""

from __future__ import annotations

from typing import Any, Dict

from s2t_tpu_torch.models import pds, s2t_ctc, s2t_transformer  # noqa: F401  (the presets)
from s2t_tpu_torch.registry import ARCHS, MODELS, register_model_architecture

# arch -> (its model, the module it needs) (s2t_tpu/models/s2t_transformer.py:1053-1168,
# s2t_tpu/models/s2t_ctc.py:71-106)
_UNPORTED_ARCHS = {
    "s2t_transformer_s_relative": ("s2t_transformer", "relative-position attention"),
    "s2t_conformer": ("s2t_transformer",
                      "the conformer block (macaron, conv module, rel_pos attention)"),
    "convtransformer": ("s2t_transformer", "the conv2d subsampler and post-norm stack"),
    "convtransformer_espnet": ("s2t_transformer", "the conv2d subsampler and post-norm stack"),
    "s2t_dynamic_transformer_s": ("s2t_transformer", "dynamic convolutions"),
    "s2t_light_transformer_s": ("s2t_transformer", "lightweight convolutions"),
    "s2t_transformer_s_dlcl": ("s2t_transformer", "the dynamic linear combination of layers"),
    "s2t_nast": ("s2t_ctc", "inter-CTC layers, the PAE adapters and XCTC"),
    "s2t_ctc_sate": ("s2t_ctc", "the SATE encoder (models/sate.py)"),
}


def _unported(arch: str, needs: str):
    def preset(**kw):
        raise NotImplementedError(f"arch {arch!r} needs {needs}, which is not ported to "
                                  "s2t_tpu_torch")

    return preset


for _arch, (_model, _needs) in _UNPORTED_ARCHS.items():
    register_model_architecture(_model, _arch)(_unported(_arch, _needs))


def build_model(arch: str, overrides: Dict[str, Any] | None = None, *, device="cuda",
                seed: int = 0, for_training: bool = False, **ctx):
    """Build a model from a registered preset.  ``ctx`` carries task-provided
    fields (vocab sizes, feature dims, position caps) applied after the
    user's ``overrides``; the weights come from ``seed`` on ``device``."""
    model_name, preset = ARCHS.get(arch)
    model_cls = MODELS.get(model_name)
    merged = {**(overrides or {}), **ctx}
    # lists from YAML -> tuples (config fields are hashable tuples)
    merged = {k: tuple(v) if isinstance(v, list) else v for k, v in merged.items()}
    try:
        cfg = preset(**merged)
    except TypeError as e:
        raise ValueError(f"unknown model config key for arch {arch!r}: {e}") from e
    return model_cls(cfg, device=device, seed=seed, for_training=for_training)
