"""``compute_dtype='bfloat16'`` in the port (``models/mlp.py``,
``models/njode.py``) against the JAX package's bf16 forward and
``jax.grad`` at dropout 0, with the same weights and batch.

Both round every matmul's two operands to bfloat16 and sum in float32;
the gradient of each operand is rounded to bfloat16 too (the JAX
transposed dots). A one-ulp difference of float32 sums before rounding
flips a bfloat16 operand by 2^-8 relative; at K = 15 and 30 steps the
port agrees with JAX at the North-star tolerances all the same (loss rtol
1e-5 / atol 1e-6, gradients rtol 2e-4 / atol 2e-5): the largest gradient
gap measured is 7.6e-6 (K = 30), the loss gap 2e-7 relative."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.models import mlp as tmlp
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.ops import fused_scan
from njode_tpu_torch.training import trainer as ttrainer


def test_config_validates_compute_dtype():
    with pytest.raises(ValueError, match="compute_dtype"):
        H.configs(1, 10, compute_dtype="float16")
    _, t32 = H.configs(1, 10)
    _, t16 = H.configs(1, 10, compute_dtype="bfloat16")
    assert not t32.bf16 and t16.bf16
    assert fused_scan.supported(t32) and not fused_scan.supported(t16)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        fused_scan.make_fused_loss_fn(t16)


@pytest.mark.parametrize("K", [15, 30])
@pytest.mark.parametrize("use_rnn,masked", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["enc", "rnn", "masked", "rnn_masked"])
def test_bf16_forward_and_grads_match_jax_bf16(K, use_rnn, masked):
    jcfg, tcfg = H.configs(2 if masked else 1, 10, use_rnn=use_rnn,
                           masked=masked, compute_dtype="bfloat16")
    params, model = H.twin_models(jcfg, tcfg)
    b = (H.make_masked_np_batch(seed=K, B=8, steps=K) if masked
         else H.make_np_batch(seed=K, B=8, steps=K))

    def loss_jax(p):
        return jnjode.forward(p, jcfg, H.jbatch(b), train=True,
                              rng=jax.random.PRNGKey(3))[1]

    l_ref, g_ref = jax.value_and_grad(loss_jax)(params)
    before = dict(tmlp.BF16_ROUTES)
    _, loss = tnjode.forward(model, H.tbatch(b), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(model)),
                               H.flat(g_ref), **H.GRAD_TOL)
    # gradients and parameters stay float32; the CPU route ran
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    cpu_route = [k for k in tmlp.BF16_ROUTES if k.startswith("cpu")][0]
    assert tmlp.BF16_ROUTES[cpu_route] > before[cpu_route]


def test_bf16_differs_from_fp32_by_rounding_only():
    """bf16 moves the loss by about 1e-2 relative (the JAX test's bound,
    tests/test_mixed_precision.py) and not by nothing."""
    _, t32 = H.configs(1, 10)
    _, t16 = H.configs(1, 10, compute_dtype="bfloat16")
    m32 = tnjode.NJODE(t32)
    m16 = tnjode.NJODE(t16)
    m16.load_state_dict(m32.state_dict())
    b = H.tbatch(H.make_np_batch(seed=1, B=16, steps=20))
    l32 = float(tnjode.forward(m32, b)[1].detach())
    l16 = float(tnjode.forward(m16, b)[1].detach())
    assert l16 != l32
    assert abs(l16 - l32) / abs(l32) < 2e-2


def test_trainer_trains_two_bf16_epochs(tmp_path):
    import pandas as pd

    data = str(tmp_path / "data")
    hp = dict(tdatasets.hyperparam_default, nb_paths=60, nb_steps=20)
    tdatasets.create_dataset("BlackScholes", hp, seed=1, base_path=data,
                             device="cpu")
    smp = str(tmp_path / "saved_models")
    launches = dict(fused_scan.LAUNCHES)
    assert ttrainer.train(
        epochs=2, batch_size=20, learning_rate=0.01, hidden_size=10,
        dropout_rate=0.1, ode_nn=((16, "tanh"),),
        readout_nn=((16, "tanh"),), enc_nn=((16, "tanh"),),
        compute_dtype="bfloat16", dataset="BlackScholes",
        base_data_path=data, saved_models_path=smp, evaluate=True,
        device="cpu") == 0
    dfm = pd.read_csv(os.path.join(smp, "id-1", "metric_id-1.csv"),
                      index_col=0)
    assert list(dfm["epoch"]) == [1, 2]
    assert np.isfinite(dfm["eval_loss"].to_numpy()).all()
    assert fused_scan.LAUNCHES == launches
    ckpt = torch.load(os.path.join(smp, "id-1", "last_checkpoint",
                                   "checkpt.tar"), weights_only=True)
    assert all(v.dtype == torch.float32
               for v in ckpt["model_state_dict"].values())


def test_study_counts_the_jax_macs_and_runs_on_the_cpu():
    """``model_macs_per_pathstep`` on the port's modules equals the JAX
    study's count on its pytree plus the ODE net's weights (the JAX
    function looks the ODE net up as 'ode', a key its pytree does not have
    ('ode_f'), and so leaves it out); ``run`` at a tiny shape gives both
    dtypes' rows and a finite loss each."""
    from njode_tpu.experiments import mixed_precision_study as jstudy
    from njode_tpu_torch.experiments import mixed_precision_study as tstudy

    for use_rnn in (False, True):
        jcfg, tcfg = H.configs(1, 10, use_rnn=use_rnn)
        params, model = H.twin_models(jcfg, tcfg)
        ode = sum(int(np.asarray(layer["w"]).size)
                  for layer in params["ode_f"])
        assert tstudy.model_macs_per_pathstep(model) == \
            jstudy.model_macs_per_pathstep(params, jcfg) + ode
    b = tstudy.make_batch(6, 10, 1, "cpu")
    jb = jstudy.make_batch(6, 10, 1)
    for f in ("obs", "X", "dt"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    rows = tstudy.run(shapes=[("tiny", 6, 10, 1, 8, 4)], reps=1, warmup=1,
                      device="cpu")
    for cd in ("float32", "bfloat16"):
        assert np.isfinite(rows[0][cd]["loss"])
    assert rows[0]["speedup"] > 0
    with pytest.raises(RuntimeError, match="CUDA card"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA card present")
        tstudy.run(shapes=[("tiny", 6, 10, 1, 8, 4)], reps=1)
