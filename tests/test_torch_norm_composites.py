"""The composites Joint, Joint2 and Embed at norm_type 2 (BatchNorm) and 3
(GSNorm) against the JAX package's on the CPU: the rules, sizes, draws and
tolerances of tests/test_torch_norm_types.py (``check_model``), which
holds the networks they are made of (the Joint's VAE half and Embed's
Fusion each held on one input, as set out there). Embed's reparam eps is
drawn once and injected into both packages.
"""

import pytest
import torch

from test_torch_norm_types import COMPOSITES, check_model

torch.set_num_threads(2)


@pytest.mark.parametrize("norm_type", [2, 3])
@pytest.mark.parametrize("kind", COMPOSITES)
def test_composite_matches_jax(kind, norm_type):
    check_model(kind, norm_type)
