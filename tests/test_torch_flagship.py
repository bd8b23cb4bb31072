"""The port's flagship eval step against ``__graft_entry__.entry()``: the
same weights carried over with ``convert.params_from_jax``, the same
inputs.  Logits within 1e-5 (two f32 matrix products summed in other
orders), argmax, accuracy and the confusion matrix exact, AUROC within
1e-6."""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import FEATURES, HIDDEN, NUM_CLASSES, entry
from torcheval_tpu_torch.convert import params_from_jax
from torcheval_tpu_torch.flagship import FlagshipMLP, eval_step
from torcheval_tpu_torch.ops import _build


@pytest.fixture(scope="module")
def flagship():
    fn, (params, x, target) = entry()
    want = {k: np.asarray(v) for k, v in fn(params, x, target).items()}
    numpy_params = {k: np.asarray(v) for k, v in params.items()}
    return numpy_params, np.array(x), np.array(target), want


def _model(numpy_params):
    model = FlagshipMLP(device="cpu")
    model.load_state_dict(params_from_jax(numpy_params))
    return model


def test_eval_step_matches_the_jax_flagship(flagship):
    numpy_params, x, target, want = flagship
    _build.reset_counts()
    got = eval_step(_model(numpy_params), torch.from_numpy(x), torch.from_numpy(target))
    # N = 1024 < 2^15: the AUROC takes the sort route (one AUC scan), the
    # 8-class matrix the one-hot matmul.
    assert dict(_build.PLAIN_CALLS) == {"auc_from_sorted": 1}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["logits"].argmax(-1).numpy(), want["logits"].argmax(-1))
    assert got["accuracy"].numpy() == want["accuracy"]
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(), want["confusion_matrix"])
    np.testing.assert_allclose(got["auroc"].numpy(), want["auroc"], rtol=0, atol=1e-6)


def test_eval_step_moves_numpy_inputs_to_the_model(flagship):
    numpy_params, x, target, want = flagship
    got = eval_step(_model(numpy_params), x, target)
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(), want["confusion_matrix"])


def test_params_from_jax_transposes_the_weights(flagship):
    numpy_params = flagship[0]
    state = params_from_jax(numpy_params)
    assert state["fc1.weight"].shape == (HIDDEN, FEATURES)
    assert state["fc2.weight"].shape == (NUM_CLASSES, HIDDEN)
    np.testing.assert_array_equal(state["fc2.weight"].numpy(), numpy_params["w2"].T)
    with pytest.raises(TypeError, match="numpy arrays"):
        params_from_jax({k: jax.numpy.asarray(v) for k, v in numpy_params.items()})


def test_model_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FlagshipMLP()
