"""The f64 Gauss-Jordan kernel (``gj_inverse64_kernel``) on the card.

Marked ``card``: each test skips without a CUDA device. On the card, run
this file alone (the tests' ``conftest.py`` loads JAX, which the card's
machine does not have)::

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_gj_inverse64_card.py

- the kernel equals its plain version (``gj_inverse_plain`` on the same
  f64 batch) bit for bit, on the edge cases of the f32 kernel and on
  near-singular Newton matrices, and the block-Schur composition over it
  equals the plain composition on the same card;
- on the near-singular matrices its inverse, rounded to f32, leaves a
  smaller residual max|I - A M| than the f32 kernel's in the batch's
  median (on the CPU's plain versions: 0.37 against 1.90 at n = 73, 0.17
  against 0.35 at n = 128).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card
F64 = torch.float64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.nan_to_num(a, nan=7.0),
                            torch.nan_to_num(b, nan=7.0)))


@pytest.mark.parametrize("n", [1, 5, 73, 128])
def test_edge_cases_equal_the_plain_version(card, n):
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse, gj_inverse_plain
    from kinetica_tpu_torch.testing.kernel_cases import gj_edge_cases
    members, _ = gj_edge_cases(n)
    A = torch.as_tensor(members, dtype=F64, device=card).contiguous()
    assert _equal(gj_inverse(A), gj_inverse_plain(A))


@pytest.mark.parametrize("n", [73, 128])
def test_near_singular_equal_the_plain_version(card, n):
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse, gj_inverse_plain
    from kinetica_tpu_torch.testing.kernel_cases import near_singular_newton
    A32 = torch.as_tensor(near_singular_newton(64, n, seed=3), device=card)
    A = A32.double().contiguous()
    M = gj_inverse(A)
    assert _equal(M, gj_inverse_plain(A))
    eye = torch.eye(n, dtype=F64, device=card)

    def residual(M32):
        return (eye - A @ M32.double()).abs().amax(dim=(1, 2))

    r64 = residual(M.float())
    r32 = residual(gj_inverse(A32.contiguous()))
    assert torch.isfinite(r64).all()
    assert float(r64.median()) < float(r32.median())


def test_schur_equals_the_plain_composition(card):
    from kinetica_tpu_torch.ops.gj_inverse import (schur_inverse,
                                                   schur_inverse_plain)
    from kinetica_tpu_torch.testing.kernel_cases import near_singular_newton
    A = torch.as_tensor(near_singular_newton(16, 181, seed=5),
                        device=card).double().contiguous()
    assert _equal(schur_inverse(A), schur_inverse_plain(A))
    assert np.isfinite(schur_inverse(A).cpu().numpy()).all()
