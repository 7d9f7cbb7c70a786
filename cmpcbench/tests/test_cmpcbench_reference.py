"""The plain reference against integer arithmetic, and its control."""
import random

import pytest
import torch

from cmpcbench import reference


def _python_y(a, w, p):
    batch, k, ma = a.shape
    mb = w.shape[1]
    al, wl = a.tolist(), w.tolist()
    return [[[sum(al[i][r][x] * wl[r][c] for r in range(k)) % p for c in range(mb)]
             for x in range(ma)] for i in range(batch)]


@pytest.mark.parametrize("p,k,chunk", [(65521, 37, None), (65521, 37, 5), (257, 12, None), (7, 9, 2)])
def test_y_exact_equals_integer_arithmetic(monkeypatch, p, k, chunk):
    if chunk is not None:  # the int64 path over chunks of the contraction
        monkeypatch.setattr(reference, "exact_terms", lambda p: chunk)
    gen = torch.Generator().manual_seed(k * p)
    a = torch.randint(0, p, (3, k, 5), generator=gen, dtype=torch.int32)
    w = torch.randint(0, p, (k, 4), generator=gen, dtype=torch.int32)
    a[0, :, 0] = p - 1  # the largest products
    w[:, 0] = p - 1
    y = reference.y_exact(a, w, p)
    assert y.dtype == torch.int64 and y.tolist() == _python_y(a, w, p)


def test_exact_terms_bound():
    n = reference.exact_terms(65521)
    assert n * 65520 ** 2 < 2 ** 53 <= (n + 1) * 65520 ** 2
    assert n > 5120 and n > 2048  # the cells' contractions run as one float64 block


def test_the_float32_control_is_wrong_at_full_range():
    p = 65521
    rnd = random.Random(3)
    a = torch.tensor([[[rnd.randrange(p) for _ in range(6)] for _ in range(64)]], dtype=torch.int32)
    w = torch.tensor([[rnd.randrange(p) for _ in range(7)] for _ in range(64)], dtype=torch.int32)
    exact = reference.y_exact(a, w, p)
    assert exact.tolist() == _python_y(a, w, p)
    assert (reference.y_float32(a, w, p) != exact).float().mean() > 0.9
