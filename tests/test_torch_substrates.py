"""The port's training substrate against ``tests/test_substrates.py``'s
checks of the reference: the token stream (deterministic, restartable,
host-sharded, and bit for bit the reference's batches), the fault-tolerant
``TrainLoop`` (bit-exact resume, a retried step, straggler flagging), the
metrics logger, and checkpoints of an LM train state (bfloat16 leaves, an
optimizer state without master copies) that the reference's reader takes.
"""

import json

import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree_dict as jax_load_pytree_dict
from repro.data import TokenStream as JaxTokenStream
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenStream, make_batch_iterator
from repro_torch.runtime import MetricsLogger, StepTimer, TrainLoop, TrainLoopConfig

torch.set_num_threads(1)


# ------------------------------ data --------------------------------- #
def test_token_stream_deterministic_and_restartable():
    s1 = TokenStream(vocab_size=1000, seq_len=32, global_batch=8, seed=7)
    s2 = TokenStream(vocab_size=1000, seq_len=32, global_batch=8, seed=7)
    for step in (0, 5, 123):
        np.testing.assert_array_equal(s1.batch_at(step)["tokens"], s2.batch_at(step)["tokens"])
    assert not np.array_equal(s1.batch_at(0)["tokens"], s1.batch_at(1)["tokens"])
    it = make_batch_iterator(s1, start_step=5)
    step, batch = next(it)
    assert step == 5 and np.array_equal(batch["tokens"], s2.batch_at(5)["tokens"])


def test_token_stream_host_sharding_partitions_global_batch():
    full = TokenStream(vocab_size=50, seq_len=8, global_batch=8, seed=1)
    tokens = full.batch_at(3)["tokens"]
    assert tokens.shape == (8, 8) and tokens.dtype == np.int32
    assert tokens.min() >= 0 and tokens.max() < 50
    for h in range(4):
        s = TokenStream(vocab_size=50, seq_len=8, global_batch=8, n_hosts=4, host_id=h, seed=1)
        assert s.batch_at(3)["tokens"].shape == (2, 8)
    with pytest.raises(ValueError):
        TokenStream(vocab_size=50, seq_len=8, global_batch=6, n_hosts=4)


@pytest.mark.parametrize("kw", [dict(vocab_size=51865, seq_len=128, global_batch=8, seed=0),
                                dict(vocab_size=256, seq_len=16, global_batch=4, seed=3,
                                     n_hosts=2, host_id=1)])
def test_token_stream_is_the_references(kw):
    ours, ref = TokenStream(**kw), JaxTokenStream(**kw)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours.state() == ref.state()


# ----------------------------- runtime ------------------------------- #
def _make_loop(tmp_path, total_steps, fail_at=None, save_every=5):
    opt = optim.sgd(lr=0.1)
    params = {"w": torch.ones((4,), dtype=torch.float32)}
    calls = {"n": 0}

    def step_fn(params, opt_state, batch):
        calls["n"] += 1
        if fail_at is not None and calls["n"] == fail_at:
            raise RuntimeError("injected failure")
        params, opt_state = opt.update({"w": batch["x"]}, opt_state, params)
        return params, opt_state, {"loss": params["w"].sum()}

    def batch_fn(step):
        return {"x": torch.full((4,), float(step + 1))}

    return TrainLoop(step_fn, batch_fn, params, opt.init(params),
                     TrainLoopConfig(total_steps=total_steps, save_every=save_every,
                                     log_every=1000, async_save=False),
                     ckpt_dir=tmp_path), calls


def test_train_loop_resume_bit_exact(tmp_path):
    loop_a, _ = _make_loop(tmp_path / "a", total_steps=12)
    out_a = loop_a.run()
    # interrupted at step 7 (after the step-5 checkpoint), then resumed
    loop_b, _ = _make_loop(tmp_path / "b", total_steps=7)
    loop_b.run()
    loop_b2, _ = _make_loop(tmp_path / "b", total_steps=12)
    out_b = loop_b2.run()
    assert torch.equal(loop_a.params["w"], loop_b2.params["w"])
    assert int(loop_b2.opt_state.step) == 12
    assert out_a["final_step"] == out_b["final_step"] == 12


def test_train_loop_retries_failed_step(tmp_path):
    loop, calls = _make_loop(tmp_path, total_steps=10, fail_at=7)
    out = loop.run()
    assert out["final_step"] == 10
    assert calls["n"] >= 11       # one extra call due to the retry


def test_train_loop_reraises_after_its_retries(tmp_path):
    loop, _ = _make_loop(tmp_path, total_steps=10)
    loop.step_fn = lambda *a: (_ for _ in ()).throw(RuntimeError("always"))
    with pytest.raises(RuntimeError, match="always"):
        loop.run()


def test_straggler_detection():
    t = StepTimer(ema=0.5, threshold=2.0, patience=2)
    for _ in range(10):
        t.record(0.1)
    assert not t.is_straggling
    t.record(1.0)
    t.record(1.0)
    assert t.is_straggling
    t.record(0.1)
    assert not t.is_straggling


def test_metrics_logger_writes_jsonl(tmp_path, capsys):
    path = tmp_path / "sub" / "m.jsonl"
    log = MetricsLogger(path, print_every=2)
    log.log(1, {"loss": torch.tensor(2.5), "grad_norm": 1.0})
    log.log(2, {"loss": 2.0})
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2] and recs[0]["loss"] == 2.5
    assert "[step      2] loss=2" in capsys.readouterr().out


# --------------------------- checkpoint ------------------------------ #
def test_lm_train_state_checkpoint_round_trip(tmp_path):
    """A bfloat16 parameter tree and an AdamW state without master copies
    save and restore bit for bit, and the reference's reader sees the
    leaves under the reference's names and dtypes."""
    import ml_dtypes
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn((5, 3), generator=gen).to(torch.bfloat16),
              "blocks": {"u0": {"ln": torch.randn((2, 3), generator=gen)}}}
    opt = optim.adamw(lr=1e-3)
    state = {"params": params, "opt_state": opt.init(params).tree()}
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(4, state)
    back = mgr.restore(4, state)
    assert back["params"]["embed"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["embed"], params["embed"])
    assert back["opt_state"]["3"] is None
    restored = optim.OptState.from_tree(back["opt_state"])
    assert restored.master is None and int(restored.step) == 0
    ref = jax_load_pytree_dict(tmp_path / "step_00000004")
    assert ref["params"]["embed"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(ref["params"]["embed"], np.float32),
                                  params["embed"].float().numpy())
    assert set(ref["opt_state"]) == {"0", "1", "2"}
