"""The 04 step of OCVPSeq in ``tpu.compute_dtype: "bfloat16"`` on the CPU,
through the frozen tiny SAVi, against the JAX package's bf16 and float32
steps: ``test_torch_port_bf16_train_predictor.py``'s case and rule for an
unconditioned predictor.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import pytest
from test_torch_port_bf16_train_predictor import build_case, check_step


@pytest.fixture(scope="module")
def jax_case():
    return build_case("OCVPSeq")


def test_the_04_step_of_ocvpseq_matches_jax_bf16_and_leaves_the_frozen_weights(jax_case,
                                                                                 tmp_path):
    check_step(jax_case, tmp_path)
