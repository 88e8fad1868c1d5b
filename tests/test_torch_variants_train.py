"""Training the encoder variants: the loss of label-smoothed CE + 0.3 CTC (rtol 1e-5)
and every gradient (atol 1e-5 of each leaf's largest entry) against
``jax.value_and_grad`` for DLCL, Shaw relative attention (encoder and decoder) and
rope (the fused attention's plain version under the rotation), on the tiny models
of tests/test_torch_variants_models.py."""

import pytest

from tests.test_torch_variants_models import variant_loss_and_grads_match
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)


@pytest.mark.parametrize("name", ["dlcl", "relative", "rope"])
def test_variant_loss_and_grads_match_jax(name):
    variant_loss_and_grads_match(name)
