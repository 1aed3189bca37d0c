"""The direction numbers of a training record against the reference's:
a change reversed reads 2, one not made reads 1, the same change 0."""

import pytest
import torch

from harness.train import _descent, _leaf_cos, train_readings


def _rec(change, grad):
    return {"change_vec": change, "grad_vec": grad}


def test_cosine_of_each_leaf():
    want = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([0.5, 0.5])}
    got = {"a": -want["a"], "b": torch.zeros(2)}
    cos = _leaf_cos(got, want, want)
    assert cos == {"a": pytest.approx(2.0), "b": 1.0}
    assert _leaf_cos(want, want, {"a"}) == {"a": pytest.approx(0.0)}
    assert _leaf_cos({}, want, {"b"}) == {"b": 1.0}


def test_descent_along_the_reference_gradient():
    grad = {"a": torch.tensor([1.0, -1.0]), "b": torch.tensor([2.0, 0.0])}
    ref = _rec({"a": torch.tensor([-1.0, 1.0]),
                "b": torch.tensor([-1.0, 5.0])}, grad)
    got = _rec({"a": torch.tensor([1.0, -1.0])}, {})
    assert _descent(ref, ref, {"a", "b"}) == {"a": -2.0, "b": -2.0}
    assert _descent(got, ref, {"a", "b"}) == {"a": 2.0, "b": 0.0}


def test_descent_and_update_gaps():
    grad = {"a": torch.tensor([1.0, -1.0]), "b": torch.tensor([2.0, 0.5])}
    change = {k: -1e-5 * torch.sign(g) for k, g in grad.items()}
    norms = lambda d: {k: float(v.norm()) for k, v in d.items()}
    ref = {"losses": [{"loss": 1.0}], "grad": norms(grad), "grad_vec": grad,
           "change": norms(change), "change_vec": change}
    same = train_readings(ref, ref)
    assert same["descent_gap"] == same["update_gap"] == 0.0
    back = {**ref, "change_vec": {k: -v for k, v in change.items()}}
    assert train_readings(back, ref)["descent_gap"] == pytest.approx(2.0)
    assert train_readings(back, ref)["update_gap"] == pytest.approx(2.0)
    # a gradient of the same norm elsewhere, followed faithfully
    turned = {"a": torch.tensor([-1.0, 1.0]), "b": torch.tensor([0.5, 2.0])}
    rec = {**ref, "grad_vec": turned,
           "change_vec": {k: -1e-5 * torch.sign(g) for k, g in
                          turned.items()}}
    got = train_readings(rec, ref)
    assert got["update_gap"] == pytest.approx(0.0)
    assert got["descent_gap"] == pytest.approx(4.0 / 4.5)
