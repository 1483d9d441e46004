"""The PyTorch port's checkpoints, training loop, training launcher and
restart supervisor, and its package namespaces against the JAX package's.

Checkpoints are the JAX package's files byte for byte: a checkpoint
written by either package restores bit-exact in the other (f32, bf16 and
int32 leaves in nested dicts and lists, with ``extra``), through the
port's own msgpack codec (its bytes are ``msgpack``'s) and either shard
codec. The loop resumes from the newest intact step, writes a rescue
checkpoint on a crash, and a resumed run is bit-equal to an unbroken one
(f32, one intra-op thread). The two checkpoint-interchange tests import
JAX; the rest of the file does not need it, and its ``cuda`` test runs one
gemma2-2b training step on the card.
"""
import ast
import copy
import dataclasses
import importlib
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import build_model, get_arch  # noqa: E402
from repro_torch.data import FailingIterator, token_batches  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import supervisor  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LMConfig, TransformerLM  # noqa: E402
from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamW,
    AsyncCheckpointer,
    LoopConfig,
    available_steps,
    gc_checkpoints,
    latest_step,
    make_lm_train_step,
    restore_checkpoint,
    run_train_loop,
    save_checkpoint,
)
from repro_torch.train import checkpoint as ckpt  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: as fast at these sizes, bit-stable across runs,
    and it leaves the cores to the files the suite runs beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    """A tensor's bits as a numpy array (bf16 as its int16 view)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _same(a, b):
    return a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape) and np.array_equal(_bits(a), _bits(b))


def _tree():
    """f32, bf16 and int32 leaves, 0-d to 3-d, in nested dicts and lists."""
    g = torch.Generator().manual_seed(0)
    return {
        "a": torch.randn(3, 4, generator=g),
        "b": {"c": torch.randn(2, 5, generator=g).to(torch.bfloat16),
              "d": [torch.arange(3, dtype=torch.int32) - 1, torch.tensor(2.5)]},
        "e": [{"f": torch.randint(-9, 9, (2, 2, 2), generator=g, dtype=torch.int32)}],
    }


EXTRA = {"note": "resume", "lr": 0.5, "n": 3, "tags": [1, -2, None, True]}


# ---------------------------------------------------------------- checkpoints


def _jax():
    jax = pytest.importorskip("jax")
    from repro.train import checkpoint as jckpt

    return jax, jckpt


def _to_jax(tree):
    import jax.numpy as jnp

    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return tree_map(conv, tree)


def test_jax_checkpoint_restores_in_the_port_bit_exact(tmp_path):
    jax, jckpt = _jax()
    t = _tree()
    jckpt.save_checkpoint(str(tmp_path), 7, _to_jax(t), EXTRA)
    got, step, extra = restore_checkpoint(str(tmp_path), t)
    assert step == 7 and extra == EXTRA
    assert all(_same(a, b) for a, b in zip(tree_leaves(got), tree_leaves(t)))


def test_port_checkpoint_restores_in_jax_bit_exact_and_the_files_are_the_same(tmp_path):
    """The JAX package restores what the port wrote, bit-exact; and the two
    packages write the same shard and manifest bytes for the same tree."""
    jax, jckpt = _jax()
    import jax.numpy as jnp

    t = _tree()
    save_checkpoint(str(tmp_path / "port"), 7, t, EXTRA)
    jt = _to_jax(t)
    got, step, extra = jckpt.restore_checkpoint(str(tmp_path / "port"), jt)
    assert step == 7 and extra == EXTRA
    for a, b in zip(jax.tree.leaves(got), tree_leaves(t)):
        assert a.dtype == (jnp.bfloat16 if b.dtype == torch.bfloat16 else b.numpy().dtype)
        a = np.asarray(a)
        assert np.array_equal(a.view(np.int16) if b.dtype == torch.bfloat16 else a, _bits(b))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 7, jt, EXTRA)
    for name in ("step_0000000007/shard_00000.ckpt", "MANIFEST"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


MSGPACK_OBJECTS = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
    0.5, -1e300, float("inf"), "", "a" * 31, "a" * 32, "é" * 200, "x" * 70000,
    b"", b"x" * 255, b"x" * 256, b"y" * 70000, [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i, {"k": b"v"}] for i in range(16)},
    {str(i): i for i in range(70000)},
]


@pytest.mark.parametrize("i", range(len(MSGPACK_OBJECTS)))
def test_codec_bytes_equal_msgpack(i):
    """The port's codec writes ``msgpack.packb(obj, use_bin_type=True)``'s
    bytes for every size class of every type it writes, and reads what
    msgpack writes (a float32 too)."""
    msgpack = pytest.importorskip("msgpack")
    obj = MSGPACK_OBJECTS[i]
    want = msgpack.packb(obj, use_bin_type=True)
    assert ckpt.packb(obj) == want
    assert ckpt.unpackb(want) == msgpack.unpackb(want, raw=False)
    single = msgpack.packb([1.5, obj], use_single_float=True)
    assert ckpt.unpackb(single) == msgpack.unpackb(single, raw=False)


def test_checkpoint_imports_neither_msgpack_nor_jax():
    code = ("import sys, repro_torch.train.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('msgpack', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("codec", ["zstd", "raw", "legacy"])
def test_both_shard_codecs_round_trip(tmp_path, monkeypatch, codec):
    """A shard declares its codec: zstd where ``zstandard`` imports, raw
    where it does not; a legacy shard (zstd payload, no codec byte) still
    reads."""
    if codec != "raw" and not ckpt.HAVE_ZSTD:
        pytest.skip("zstandard not installed")
    if codec == "raw":
        monkeypatch.setattr(ckpt, "HAVE_ZSTD", False)
    t = _tree()
    shard = Path(save_checkpoint(str(tmp_path), 3, t))
    rawlen, code = struct.unpack("<QB", shard.read_bytes()[:9])
    assert code == (ckpt.CODEC_RAW if codec == "raw" else ckpt.CODEC_ZSTD) and rawlen > 0
    if codec == "legacy":
        data = shard.read_bytes()
        shard.write_bytes(data[:8] + data[9:])
    got, step, _ = restore_checkpoint(str(tmp_path), t)
    assert step == 3 and all(_same(a, b) for a, b in zip(tree_leaves(got), tree_leaves(t)))


def test_corrupt_newest_step_falls_back(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    save_checkpoint(str(tmp_path), 2, tree_map(lambda x: x + 1, t))
    shard = tmp_path / "step_0000000002" / "shard_00000.ckpt"
    data = bytearray(shard.read_bytes())
    data[50:60] = b"corrupted!"
    shard.write_bytes(bytes(data))
    got, step, _ = restore_checkpoint(str(tmp_path), t)
    assert step == 1 and all(_same(a, b) for a, b in zip(tree_leaves(got), tree_leaves(t)))


def test_shape_mismatch_is_rejected(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    bad = dict(t, a=torch.zeros(4, 4))
    with pytest.raises(FileNotFoundError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), bad)


def test_restore_places_each_leaf_on_its_template_leaf_device(tmp_path):
    """Without ``device`` a leaf restores onto its template leaf's device
    (the CPU for a meta tensor); with it, every leaf goes there."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
    for template, device in ((t, None), (meta, None), (meta, "cpu")):
        got, _, _ = restore_checkpoint(str(tmp_path), template, device=device)
        assert all(a.device.type == "cpu" and _same(a, b) for a, b in zip(tree_leaves(got), tree_leaves(t)))


def test_gc_keeps_the_newest(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, _tree())
    gc_checkpoints(str(tmp_path), keep=2)
    assert available_steps(str(tmp_path)) == [3, 4] and latest_step(str(tmp_path)) == 4


def test_async_checkpointer_saves_what_it_was_given(tmp_path):
    """``save`` copies the tree to the host before it returns, so a step
    that then writes into the same buffers does not change what is
    written; ``keep`` bounds the steps on disk."""
    t = _tree()
    want = copy.deepcopy(t)
    saver = AsyncCheckpointer(str(tmp_path), keep=2)
    saver.save(5, t, {"k": 1})
    t["a"].add_(1.0)
    t["b"]["c"].mul_(2)
    saver.save(6, t)
    saver.save(7, t)
    saver.close()
    assert available_steps(str(tmp_path)) == [6, 7]
    got, step, _ = restore_checkpoint(str(tmp_path), t, step=6)
    assert step == 6 and all(_same(a, b) for a, b in zip(tree_leaves(got), tree_leaves(t)))
    save_checkpoint(str(tmp_path / "first"), 5, want)
    assert all(_same(a, b) for a, b in zip(tree_leaves(restore_checkpoint(str(tmp_path / "first"), t)[0]),
                                           tree_leaves(want)))


# ---------------------------------------------------------------- the loop


def _lm():
    cfg = LMConfig(name="t", n_layers=1, d_model=32, n_q=2, n_kv=2, head_dim=16, d_ff=64, vocab=128,
                   act_dtype=torch.float32)
    lm = TransformerLM(cfg)
    return lm, lm.init(torch.Generator().manual_seed(0))


BATCHES = [{k: torch.from_numpy(v) for k, v in b.items()}
           for b, _ in zip(token_batches(2, 16, 128, seed=0), range(20))]


def _fresh(p, opt):
    p = tree_map(torch.clone, p)
    return p, opt.init(p)


def _quiet(*_):
    pass


def test_loop_resume_and_crash_recovery_is_bit_equal_to_an_unbroken_run(tmp_path):
    """A port of ``tests/test_train_infra.py::test_loop_resume_and_crash_recovery``
    on the donating step: a run to 8 with checkpoints every 4, resumed to
    12; then a crash (the data fails after one batch) that leaves a rescue
    checkpoint at 13, resumed to 15. The resumed runs' parameters and
    optimizer state are bit-equal to an unbroken run's at 12 and 15."""
    lm, p0 = _lm()
    opt = AdamW(lr=1e-3)
    step = make_lm_train_step(lm, opt, donate=True)
    unbroken = {}
    p, st = _fresh(p0, opt)
    for i, b in enumerate(BATCHES[:15]):
        p, st, _ = step(p, st, b)
        if i + 1 in (12, 15):
            unbroken[i + 1] = copy.deepcopy((p, st))

    d = str(tmp_path)
    out = run_train_loop(step, *_fresh(p0, opt), iter(BATCHES), LoopConfig(8, d, ckpt_every=4, log_every=100),
                         log_fn=_quiet)
    assert out.step == 8 and available_steps(d) == [4, 8]
    logs = []
    out = run_train_loop(step, *_fresh(p0, opt), iter(BATCHES[8:]), LoopConfig(12, d, ckpt_every=4, log_every=100),
                         log_fn=logs.append)
    assert out.step == 12 and "[loop] resumed from step 8" in logs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((out.params, out.opt_state)),
                                                  tree_leaves(unbroken[12])))
    with pytest.raises(RuntimeError, match="injected"):
        run_train_loop(step, *_fresh(p0, opt), FailingIterator(iter(BATCHES[12:]), 1),
                       LoopConfig(20, d, ckpt_every=4, log_every=100), log_fn=_quiet)
    assert latest_step(d) == 13
    out = run_train_loop(step, *_fresh(p0, opt), iter(BATCHES[13:]), LoopConfig(15, d, ckpt_every=4, log_every=100),
                         log_fn=_quiet)
    assert out.step == 15
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((out.params, out.opt_state)),
                                                  tree_leaves(unbroken[15])))


def test_seeded_steps_draw_the_same_after_a_resume(tmp_path):
    """With ``seed`` each step gets a generator that is a function of
    (seed, step): a run resumed at step 3 draws what an unbroken run does."""

    def noisy(p, s, b, g):
        w = p["w"] + torch.rand(3, generator=g)
        return {"w": w}, s, {"loss": w.sum()}

    p0 = {"w": torch.zeros(3)}
    unbroken = run_train_loop(noisy, p0, {}, iter(BATCHES), LoopConfig(6), seed=11, log_fn=_quiet)
    d = str(tmp_path)
    run_train_loop(noisy, p0, {}, iter(BATCHES), LoopConfig(3, d), seed=11, log_fn=_quiet)
    resumed = run_train_loop(noisy, p0, {}, iter(BATCHES), LoopConfig(6, d), seed=11, log_fn=_quiet)
    assert torch.equal(resumed.params["w"], unbroken.params["w"])
    other = run_train_loop(noisy, p0, {}, iter(BATCHES), LoopConfig(6), seed=12, log_fn=_quiet)
    assert not torch.equal(other.params["w"], unbroken.params["w"])


def test_straggler_watchdog():
    calls = {"n": 0}

    def slow_step(p, s, b):
        calls["n"] += 1
        if calls["n"] == 5:
            time.sleep(0.25)
        return p, s, {"loss": torch.zeros(())}

    out = run_train_loop(slow_step, {"w": torch.zeros(())}, {}, iter(BATCHES),
                         LoopConfig(8, None, log_every=100, straggler_factor=3.0), log_fn=_quiet)
    assert any(s[0] == 5 for s in out.straggler_events)


# ---------------------------------------------------------------- launchers


def test_launch_train_smoke_runs_on_the_cpu(tmp_path, capsys):
    """``launch.train.main`` trains the smoke gemma2-2b for 3 steps, logs
    every step with ``--log-every 1``, and leaves its final checkpoint."""
    d = str(tmp_path / "ckpt")
    out = launch_train.main(["--arch", "gemma2_2b", "--smoke", "--steps", "3", "--batch", "2", "--seq", "32",
                             "--device", "cpu", "--log-every", "1", "--ckpt-dir", d])
    assert out.step == 3 and [h["step"] for h in out.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out.history)
    assert "[train] finished at step 3; stragglers=" in capsys.readouterr().out
    assert latest_step(d) == 3


def test_launch_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("flags,error,match", [pytest.param(f, e, m, id=f[0]) for f, e, m in [
    (["--model-parallel", "2"], RuntimeError, "model axis of 2 does not divide 1 ranks"),
    (["--production-mesh"], RuntimeError, "need 256 ranks"),
    (["--multipod", "--production-mesh"], RuntimeError, "need 512 ranks"),
    (["--coordinator", "localhost:1234"], KeyError, "NPROC"),
    (["--num-processes", "2", "--coordinator", "localhost:1234"], KeyError, "PROCESS_ID"),
    (["--process-id", "0", "--coordinator", "localhost:1234"], KeyError, "NPROC"),
]])
def test_launch_train_distributed_flags_raise(flags, error, match, monkeypatch):
    """Every mesh and multi-process flag reaches the distributed stack: a
    launch that one process cannot satisfy raises what the JAX launcher
    raises (too few ranks for the mesh; a coordinator without the process
    count or index, in flags or env vars), and leaves no process group."""
    for var in ("COORDINATOR_ADDRESS", "NPROC", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(error, match=match):
        launch_train.main(["--smoke", "--steps", "1", "--device", "cpu", *flags])
    assert not torch.distributed.is_initialized()


def test_supervise_restarts_a_command_that_fails_once(tmp_path):
    marker = tmp_path / "ran"
    cmd = [sys.executable, "-c",
           f"import pathlib, sys; m = pathlib.Path({str(marker)!r}); ok = m.exists(); m.touch(); "
           "sys.exit(0 if ok else 3)"]
    logs = []
    assert supervisor.supervise(cmd, max_restarts=2, backoff=0.0, log=logs.append) == 0
    assert sum("attempt" in line for line in logs) == 2 and "exit=3" in logs[1]


def test_supervisor_gives_up_with_the_command_exit_code():
    with pytest.raises(SystemExit) as e:
        supervisor.main(["--max-restarts", "0", "--", sys.executable, "-c", "raise SystemExit(5)"])
    assert e.value.code == 5


# ---------------------------------------------------------------- namespaces

# names of the JAX package's namespaces that the port exports under the
# card's name: the TPU engine pair and its peaks are the H100's
RENAMED = {
    "core": {
        "tpu_submesh_engines": "h100_submesh_engines",
        "TPU_V5E_BF16_FLOPS": "H100_BF16_FLOPS",
        "TPU_V5E_HBM_BW": "H100_HBM_BW",
        "TPU_V5E_ICI_BW": "H100_LINK_BW",
    },
}


@pytest.mark.parametrize("pkg", ["core", "serve", "kernels", "train", "data", "nn", "models", "configs", "dist"])
def test_port_namespaces_export_the_jax_names(pkg):
    """Every name the JAX package's ``__init__.py`` exports (read from its
    source, without importing JAX) is an attribute of the port's package
    of the same name, or its renamed counterpart is; and every renamed
    name is one the JAX package exports."""
    tree = ast.parse((SRC / "repro" / pkg / "__init__.py").read_text())
    names = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names}
    port = importlib.import_module(f"repro_torch.{pkg}")
    renamed = RENAMED.get(pkg, {})
    assert set(renamed) <= names
    missing = {n for n in names if not hasattr(port, renamed.get(n, n))}
    assert missing == set()


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_cuda_gemma2_2b_two_layer_bf16_step():
    """One donating AdamW step of gemma2-2b at full width with 2 layers (one
    local, one global), bf16 activations, batch 2 x 256, on the card: the
    loss is finite, every parameter leaf moved, no kernel launched under
    autograd, and the plain attention route was taken once per layer in
    the forward and once more in remat's recompute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("gemma2_2b").config, n_layers=2, act_dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    before = [t.clone() for t in tree_leaves(params)]
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256)).astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    kernels.grad_routes.clear()
    params, state, m = make_lm_train_step(model, opt, donate=True)(params, state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(m["loss"].item()) and int(state["step"]) == 1
    assert not any({**attn_ops.launches, **ssd_ops.launches}.values())
    assert dict(kernels.grad_routes) == {"flash_attention": 4}
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
