"""The port's training substrate on the CPU: the mirror of
``tests/test_substrates.py`` (AdamW, the token stream, checkpoints, the
train loop) run on ``repro_torch``, and parity with the reference —
``warmup_cosine``, ``TokenStream.batch_at`` byte for byte, ``apply_updates``
over 3 steps with float32 and int8 moments, the reference's ``TrainLoop``
step against the port's from the same parameters (``accum_steps`` 1 and 2),
and a 10 + 10 restart against a straight 20-step run.

Tolerances (relative):

  * ``warmup_cosine``: 1e-6 (float32 ``cos`` of XLA and PyTorch).
  * ``apply_updates``, float32 moments: parameters 2e-6 after 3 steps (the
    global norm's sum runs in another order).  Int8 moments: codes equal
    but for at most 0.1% that differ by exactly 1 (a float32 last-bit
    difference before a rounding tie), scales 1e-6.  The reference runs op
    by op: compiled, XLA may divide by the constant 127 through its
    reciprocal.
  * ``TrainLoop``: the loss at step 1 within 1e-4, at step 5 within 1e-3
    (float32 differences compound through 4 updates; measured in
    ``PERF.md``).
  * the restart: bit for bit.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import TokenStream as JTokenStream
from repro.data import TokenStreamConfig as JTokenStreamConfig
from repro.launch.train import TrainLoop as JTrainLoop
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.checkpoint import CheckpointManager, store
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.launch.train import TrainLoop
from repro_torch.models import params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_step, apply_updates
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim import constant, warmup_cosine

torch.set_num_threads(1)

_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                               "xla_llvm_disable_expensive_passes": True})


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()
                 / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# optimizer (mirror of TestAdamW)
# ---------------------------------------------------------------------------


def _quad_loss(params, batch):
    err = params["w"] - batch["target"]
    return (err ** 2).sum(), {"e": torch.zeros(())}


class TestAdamW:
    def _run(self, bits, steps=60):
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, state_bits=bits)
        params = {"w": torch.ones((8, 16)) * 3.0}
        batch = {"target": torch.zeros((8, 16))}
        state = adamw_mod.init(params, cfg)
        for _ in range(steps):
            params, state, m = adamw_step(_quad_loss, params, state, batch,
                                          cfg)
        return params, m

    def test_converges_f32(self):
        params, m = self._run(32)
        assert float(params["w"].abs().max()) < 0.5

    def test_converges_int8_moments(self):
        """Fixed-point (paper C1) Adam moments still optimize."""
        params, m = self._run(8)
        assert float(params["w"].abs().max()) < 0.6

    def test_int8_state_is_int8(self):
        cfg = AdamWConfig(state_bits=8)
        params = {"w": torch.ones((8, 16))}
        state = adamw_mod.init(params, cfg)
        assert state["m"]["w"]["codes"].dtype == torch.int8
        assert tuple(state["m"]["w"]["codes"].shape) == (8, 16)

    def test_grad_clip(self):
        cfg = AdamWConfig(lr=0.1, grad_clip=1e-3)
        params = {"w": torch.ones((4,))}
        before = params["w"].clone()
        state = adamw_mod.init(params, cfg)
        huge = {"w": torch.full((4,), 1e6)}
        new_params, _, m = apply_updates(params, huge, state, cfg)
        assert float(m["grad_norm"]) > 1e5
        assert float((new_params["w"] - before).abs().max()) < 0.2

    def test_accumulation_matches_full_batch(self):
        """k-microbatch accumulation == one full-batch step."""
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
        batch = {"target": torch.tensor(
            np.random.default_rng(0).normal(size=(4, 8)), dtype=torch.float32)}

        def loss(p, b):
            return ((p["w"] - b["target"]) ** 2).mean(), {}

        p_full = {"w": torch.ones((1, 8))}
        adamw_step(loss, p_full, adamw_mod.init(p_full, cfg), batch, cfg)
        p_acc = {"w": torch.ones((1, 8))}
        adamw_step(loss, p_acc, adamw_mod.init(p_acc, cfg), batch, cfg,
                   accum_steps=2)
        np.testing.assert_allclose(p_full["w"].numpy(), p_acc["w"].numpy(),
                                   atol=1e-5)


def _opt_tree(rng):
    return {"a": rng.normal(size=(16, 24)).astype(np.float32),
            "b": {"c": rng.normal(size=(24,)).astype(np.float32),
                  "d": rng.normal(size=(3, 5, 8)).astype(np.float32)}}


@pytest.mark.parametrize("bits", [32, 8])
def test_apply_updates_matches_reference(bits):
    """Three AdamW steps on the same parameters and gradients: the port's
    in-place update against the reference's (run op by op)."""
    rng = np.random.default_rng(bits)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    jcfg = JAdamWConfig(lr=1e-2, state_bits=bits)
    tcfg = AdamWConfig(lr=1e-2, state_bits=bits)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp, jcfg)
    tp = T.map_leaves(torch.tensor, params)
    ts = adamw_mod.init(tp, tcfg)
    lr = jschedule.warmup_cosine(1e-2, 2, 10)
    tlr = warmup_cosine(1e-2, 2, 10)
    for i, g in enumerate(grads):
        with jax.disable_jit():
            jp, js, jm = jadamw.apply_updates(
                jp, jax.tree.map(jnp.asarray, g), js, jcfg,
                lr=lr(jnp.int32(i)))
        out, ts, tm = apply_updates(tp, T.map_leaves(torch.tensor, g), ts,
                                    tcfg, lr=tlr(torch.tensor(i)))
        assert out is tp
        assert _rel(tm["grad_norm"], jm["grad_norm"]) < 1e-6
    assert int(ts["step"]) == int(js["step"]) == 3
    for (_, got), want in zip(T.leaves_with_paths(tp), jax.tree.leaves(jp)):
        assert _rel(got, want) < 2e-6
    for moment in ("m", "v"):
        got = T.leaves(ts[moment])
        want = jax.tree.leaves(js[moment])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if g.dtype == torch.int8:  # codes
                diff = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 and (diff == 1).mean() <= 1e-3
            else:  # float32 moments and int8 scales
                assert _rel(g, w) < (2e-6 if bits == 32 else 1e-6)


def test_schedules_match_reference():
    steps = np.arange(0, 121, dtype=np.int32)
    want = jschedule.warmup_cosine(3e-3, 10, 100)(jnp.asarray(steps))
    got = warmup_cosine(3e-3, 10, 100)(torch.tensor(steps))
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-6
    assert float(constant(1e-3)(torch.tensor(5))) == float(
        jschedule.constant(1e-3)(jnp.int32(5)))


# ---------------------------------------------------------------------------
# data pipeline (mirror of TestTokenStream)
# ---------------------------------------------------------------------------


class TestTokenStream:
    def _cfg(self, **kw):
        return TokenStreamConfig(vocab_size=512, seq_len=32, global_batch=8,
                                 **kw)

    def test_deterministic_and_resumable(self):
        s1 = TokenStream(self._cfg())
        b5 = s1.batch_at(5)
        s2 = TokenStream(self._cfg(), start_step=5)
        b5b = next(iter(s2))
        np.testing.assert_array_equal(b5["tokens"], b5b["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = TokenStream(self._cfg()).batch_at(0)
        assert b["tokens"].shape == (8, 32)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions(self):
        full = [TokenStream(self._cfg(n_hosts=2, host_index=h)).batch_at(3)[
            "tokens"] for h in range(2)]
        assert full[0].shape == (4, 32)
        assert not np.array_equal(full[0], full[1])

    def test_has_learnable_structure(self):
        toks = TokenStream(self._cfg()).batch_at(0)["tokens"]
        assert (toks[:, 1:] == toks[:, :-1]).mean() > 0.01

    @given(st.integers(0, 1000))
    @settings(max_examples=20, deadline=None)
    def test_any_step_regenerable(self, step):
        s = TokenStream(self._cfg())
        np.testing.assert_array_equal(s.batch_at(step)["tokens"],
                                      s.batch_at(step)["tokens"])


@pytest.mark.parametrize("seed,n_hosts,host", [(0, 1, 0), (7, 1, 0),
                                               (3, 2, 1)])
def test_token_stream_byte_identical_to_reference(seed, n_hosts, host):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=6 if n_hosts == 1
              else 8, seed=seed, n_hosts=n_hosts, host_index=host)
    mine, ref = TokenStream(TokenStreamConfig(**kw)), JTokenStream(
        JTokenStreamConfig(**kw))
    for step in (0, 1, 17, 1000):
        got, want = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    it, jit_ = iter(TokenStream(TokenStreamConfig(**kw), start_step=4)), \
        iter(JTokenStream(JTokenStreamConfig(**kw), start_step=4))
    for _ in range(2):
        assert next(it)["tokens"].tobytes() == next(jit_)["tokens"].tobytes()


# ---------------------------------------------------------------------------
# checkpointing (mirror of TestCheckpoint)
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def _tree(self, seed=0):
        rng = np.random.default_rng(seed)
        return {"a": torch.tensor(rng.normal(size=(16, 8)),
                                  dtype=torch.float32),
                "nested": {"b": torch.arange(10, dtype=torch.int32),
                           "c": torch.tensor(rng.normal(size=(4,))).to(
                               torch.bfloat16)},
                "meta": np.asarray([3, 4], np.int64)}

    def test_roundtrip(self, tmp_path):
        tree = self._tree()
        store.save(str(tmp_path), 7, tree)
        back = store.restore(str(tmp_path), 7, tree)
        for (pa, a), (pb, b) in zip(T.leaves_with_paths(tree),
                                    T.leaves_with_paths(back)):
            assert pa == pb
            if isinstance(a, torch.Tensor):
                assert b.dtype == a.dtype and torch.equal(a, b)
            else:
                np.testing.assert_array_equal(a, b)
        with open(os.path.join(str(tmp_path), "step_00000007",
                               "manifest.json")) as f:
            text = f.read()
        assert "\"['nested']['c']\"" in text and '"bfloat16"' in text

    def test_latest_step_discovery(self, tmp_path):
        for s in (3, 10, 7):
            store.save(str(tmp_path), s, self._tree())
        assert store.latest_step(str(tmp_path)) == 10
        assert store.all_steps(str(tmp_path)) == [3, 7, 10]

    def test_async_save(self, tmp_path):
        """The snapshot is a copy: an in-place update after ``save_async``
        returns does not reach the checkpoint."""
        tree = self._tree()
        want = tree["a"].clone()
        store.save_async(str(tmp_path), 1, tree)
        tree["a"].add_(1.0)
        store.wait_for_async()
        assert store.latest_step(str(tmp_path)) == 1
        assert torch.equal(store.restore(str(tmp_path), 1, tree)["a"], want)

    def test_structure_mismatch_rejected(self, tmp_path):
        store.save(str(tmp_path), 0, self._tree())
        with pytest.raises(ValueError):
            store.restore(str(tmp_path), 0, {"a": torch.zeros((16, 8))})

    def test_atomicity_no_partial_dirs(self, tmp_path):
        """A tmp dir must never be picked up as a checkpoint."""
        os.makedirs(os.path.join(str(tmp_path), "step_00000005.tmp0"))
        assert store.latest_step(str(tmp_path)) is None

    def test_manager_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every=1, keep=2,
                                async_save=False)
        for s in range(1, 6):
            mgr.save(s, self._tree())
        assert store.all_steps(str(tmp_path)) == [4, 5]


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


def _loop(ckpt_dir=None, **kw):
    cfg = reduced(get_config("qwen2-1.5b"), accum_steps=1)
    kw = dict(dict(lr=3e-3, total_steps=30, global_batch=4, seq_len=32,
                   ckpt_every=10), **kw)
    return TrainLoop(cfg, ckpt_dir=ckpt_dir, device="cpu", **kw)


class TestTrainLoop:
    def test_loss_decreases_and_resumes(self, tmp_path):
        state, hist = _loop(str(tmp_path)).run(max_steps=20, log_every=5)
        assert hist[-1]["loss"] < hist[0]["loss"]
        assert state["step"] == 20
        # crash-restart: a fresh loop resumes from step 20, same stream pos
        state2, hist2 = _loop(str(tmp_path)).run(max_steps=25, log_every=5)
        assert state2["step"] == 25
        assert hist2[-1]["loss"] < hist[0]["loss"] * 1.2


def test_restart_is_bit_exact(tmp_path):
    """10 steps, a checkpoint and a fresh loop for 10 more equal one
    straight 20-step run: parameters, moments and the stream position."""
    kw = dict(global_batch=2, seq_len=16)
    _loop(str(tmp_path), **kw).run(max_steps=10, log_every=10)
    resumed, _ = _loop(str(tmp_path), **kw).run(max_steps=20, log_every=10)
    straight, _ = _loop(**kw).run(max_steps=20, log_every=10)
    assert resumed["data_step"] == straight["data_step"] == 20
    for key in ("params", "opt"):
        for a, b in zip(T.leaves(resumed[key]), T.leaves(straight[key])):
            assert torch.equal(a, b)


def test_preemption_checkpoints_and_exits(tmp_path):
    """With the SIGTERM flag set, the loop checkpoints at the next step
    boundary and stops; a fresh loop resumes there."""
    loop = _loop(str(tmp_path), global_batch=2, seq_len=16)
    loop.ckpt.preempted.set()
    state, _ = loop.run(max_steps=10, log_every=1)
    assert state["step"] == 1 and store.latest_step(str(tmp_path)) == 1
    resumed = _loop(str(tmp_path), global_batch=2, seq_len=16)
    assert resumed.restore_or_init()["data_step"] == 1


def test_cli_on_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
                 "--batch", "2", "--seq", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    last = json.loads(out[-1])
    assert last["steps"] == 3 and np.isfinite(last["final_loss"])


def test_train_loop_refuses_a_mesh():
    """A mesh that is not a ``DeviceMesh`` is refused (the sharded loop
    itself: ``tests/test_torch_train_sharded.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        _loop(mesh=object())


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    """The reference's ``TrainLoop`` step and the port's, each fed its own
    stream (byte-identical) from the reference's initial parameters:
    reduced qwen2-1.5b in float32, 5 steps."""
    over = dict(dtype="float32", accum_steps=accum)
    kw = dict(lr=3e-3, warmup=2, total_steps=30, global_batch=4, seq_len=32)
    jloop = JTrainLoop(jreduced(jget_config("qwen2-1.5b")).replace(**over),
                       **kw)
    tloop = TrainLoop(reduced(get_config("qwen2-1.5b")).replace(**over),
                      device="cpu", **kw)
    jstate = jloop.init_state(0)
    jparams, jopt = jstate["params"], jstate["opt"]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    topt = adamw_mod.init(tparams, tloop.opt_cfg)
    jstep = _jit(jloop._step.__wrapped__)
    losses = []
    for i in range(5):
        jb = jax.tree.map(jnp.asarray, jloop.stream.batch_at(i))
        tb = {k: torch.as_tensor(v)
              for k, v in tloop.stream.batch_at(i).items()}
        jparams, jopt, jm = jstep(jparams, jopt, jb, jnp.int32(i))
        tparams, topt, tm = tloop._step(tparams, topt, tb,
                                        torch.tensor(i, dtype=torch.int32))
        losses.append((float(tm["loss"]), float(jm["loss"])))
    rel = [abs(a - b) / b for a, b in losses]
    assert rel[0] < 1e-4, losses
    assert rel[4] < 1e-3, losses
