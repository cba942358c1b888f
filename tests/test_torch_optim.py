"""The port's optimizers vs the JAX package's optax chains.

The schedules (learning rate and Adam's b1) must equal JAX's float32 values
at every step of a 200-step run within 2e-7 of the schedule's peak: XLA's
and torch's float32 cosines differ by a rounding on ~5% of arguments, and
cos(π·pct) + 1 cancels near the end of a cycle.
Fed the same gradients for 5 steps, one of which is clipped, the port's
updates must equal optax's within 1e-6 of each tensor's update norm, and the
parameters after each step within one float32 rounding; both compute in
float32, and only the gradient norm's summation order differs."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modest_tpu.train import optim as joptim
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION
from modest_tpu_torch.train import optim as toptim
from modest_tpu_torch.utils.config import Config

STEPS = 200


def _f32(fn, steps):
    return np.array([np.float32(fn(s)) for s in steps], np.float32)


def assert_schedule_equal(port_fn, jax_fn):
    jit = jax.jit(jax_fn)
    got = _f32(port_fn, range(STEPS))
    want = _f32(lambda s: jit(jnp.int32(s)), range(STEPS))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7 * np.abs(want).max())


def test_one_cycle_schedules_equal_jax():
    args = (0.01, (0.95, 0.85), 10.0, 0.4, STEPS)
    tl, tb = toptim.one_cycle_schedules(*args)
    jl, jb = joptim.one_cycle_schedules(*args)
    assert_schedule_equal(tl, jl)
    assert_schedule_equal(tb, jb)
    assert abs(float(tl(80)) - 0.01) < 1e-6 and abs(float(tb(80)) - 0.85) < 1e-6


def test_one_cycle_flat_schedules_equal_jax():
    args = (0.003, (0.95, 0.85), 10.0, 0.3, 0.6, STEPS)
    for t, j in zip(toptim.one_cycle_flat_schedules(*args),
                    joptim.one_cycle_flat_schedules(*args)):
        assert_schedule_equal(t, j)


@pytest.mark.parametrize("warmup", [0, 30])
def test_decay_list_schedule_equals_jax(warmup):
    args = (0.002, [60, 120, 150], 0.1, 1e-5)
    assert_schedule_equal(
        toptim.decay_list_schedule(*args, warmup_steps=warmup, warmup_eta_min=0.0002),
        joptim.decay_list_schedule(*args, warmup_steps=warmup, warmup_eta_min=0.0002))


def opt_cfg(name):
    cfg = dict(POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION, OPTIMIZER=name, LR=0.01)
    if name == "adam_onecycleflat":
        cfg["FLAT_START"] = 0.6
    return cfg


SHAPES = {"w0": (16, 7), "b0": (16,), "bn_scale": (16,), "w1": (3, 16), "one": (1,)}


@pytest.mark.parametrize("name", ["adam_onecycle", "adam_onecycleflat", "adam", "sgd"])
def test_updates_equal_optax(name):
    rng = np.random.RandomState(0)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in SHAPES.items()}
    total = 10
    jopt = joptim.build_optimizer(JConfig(opt_cfg(name)), total, iters_per_epoch=2)
    jstate = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    jupdate = jax.jit(jopt.update)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = toptim.build_optimizer(list(tp.values()), Config(opt_cfg(name)), total,
                                  iters_per_epoch=2)
    clipped = 0
    for step in range(5):
        scale = 30.0 if step == 2 else 0.3  # step 2: global norm above GRAD_NORM_CLIP = 10
        grads = {k: rng.normal(0, scale, s).astype(np.float32) for k, s in SHAPES.items()}
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
        clipped += norm >= 10
        updates, jstate = jupdate({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp_new = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        upd, got_norm = topt.updates()
        assert abs(float(got_norm) - norm) <= 1e-6 * norm
        for (k, p), u in zip(tp.items(), upd):
            want = np.asarray(updates[k])
            err = np.linalg.norm(u.numpy() - want) / max(np.linalg.norm(want), 1e-30)
            assert err <= 1e-6, (name, step, k, err)
            p += u
            # p + u rounds on both sides: equal within a rounding of p
            np.testing.assert_allclose(p.numpy(), np.asarray(jp_new[k]), rtol=2e-7, atol=1e-8)
        jp = jp_new
    assert clipped == 1
    assert topt.count == 5


def test_state_dict_round_trip():
    params = [torch.ones(3), torch.zeros(2, 2)]
    opt = toptim.build_optimizer(params, Config(opt_cfg("adam_onecycle")), 10)
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    other = toptim.build_optimizer([p.clone() for p in params],
                                   Config(opt_cfg("adam_onecycle")), 10)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and all(torch.equal(a, b) for a, b in zip(other.mu, opt.mu))
    with pytest.raises(ValueError):
        toptim.build_optimizer(params, Config(opt_cfg("sgd")), 10).load_state_dict(
            opt.state_dict())
