"""The captured LM decode step (``make_lm_decode_step``): on the card the
step is ``model.decode_step`` captured into one CUDA graph per cache set and
replayed for every token, as the JAX launcher's ``jax.jit`` compiles it once
for every ``t``.

On the CPU the step runs the model's own step (the caller asked for the CPU)
and captures nothing. On the card (``cuda`` marker), for gemma2-2b and
Hymba at smoke widths in f32 over 16 tokens: the captured step generates the
eager step's tokens with logits within 1e-6, from one capture per cache set
(a new one for new caches), writing into the caller's caches; the SSM
states advance once per call; and a capture that meets a host sync raises,
naming the model.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import make_lm_decode_step  # noqa: E402

ARCHS = ("gemma2_2b", "hymba_1_5b")
B, STEPS = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, device):
    model = configs.build_model(dataclasses.replace(configs.get_arch(arch).smoke, act_dtype=torch.float32))
    params = model.init(torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, model.cfg.vocab, (B, 4)).astype(np.int32)).to(device)
    return model, params, prompt


def _generate(step, params, prompt, caches, position=int):
    """Greedy decoding over ``STEPS`` tokens, the prompt fed first; the
    logits of every step and the tokens."""
    tok, logits_all, toks = prompt[:, :1], [], []
    for t in range(STEPS):
        logits, caches = step(params, tok, caches, position(t))
        logits_all.append(logits)
        tok = prompt[:, t + 1 : t + 2] if t + 1 < prompt.shape[1] else torch.argmax(logits[:, -1:], -1).to(tok.dtype)
        toks.append(tok)
    return torch.cat(logits_all, 1), torch.cat(toks, 1), caches


@pytest.mark.parametrize("position", [int, lambda t: torch.tensor(t, dtype=torch.int32)], ids=["int", "tensor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_step_is_the_models_step_and_captures_nothing(arch, position):
    model, params, prompt = _setup(arch, "cpu")
    step = make_lm_decode_step(model)
    got = _generate(step, params, prompt, model.init_caches(B, STEPS, dtype=torch.float32), position)
    want = _generate(torch.no_grad()(model.decode_step), params, prompt,
                     model.init_caches(B, STEPS, dtype=torch.float32))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert step.graphs == {}


# ---- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_captured_step_equals_eager_with_one_capture_per_cache_set(arch):
    _card()
    model, params, prompt = _setup(arch, "cuda")
    step = make_lm_decode_step(model)
    eager = torch.no_grad()(model.decode_step)
    want_logits, want_toks, _ = _generate(eager, params, prompt, model.init_caches(B, STEPS, dtype=torch.float32,
                                                                                   device="cuda"))
    caches = model.init_caches(B, STEPS, dtype=torch.float32, device="cuda")
    given = tree_leaves(caches)
    logits, toks, out = _generate(step, params, prompt, caches)
    assert all(a is b for a, b in zip(tree_leaves(out), given))  # the caller's own caches
    assert torch.equal(toks, want_toks)
    torch.testing.assert_close(logits, want_logits, atol=1e-6, rtol=0)
    assert len(step.graphs) == 1 and next(iter(step.graphs.values())).replays == STEPS
    again = model.init_caches(B, STEPS, dtype=torch.float32, device="cuda")  # other storage: a capture of its own
    _, toks2, _ = _generate(step, params, prompt, again, lambda t: torch.tensor(t, dtype=torch.int32, device="cuda"))
    assert torch.equal(toks2, want_toks) and len(step.graphs) == 2
    del caches, out, given  # keep `again` alive: its storage is not handed back to a later capture


@pytest.mark.cuda
def test_card_ssm_states_advance_once_per_call():
    """Hymba's SSM and conv states after each captured call equal one eager
    step's from the same states: the capture's warm-up ran on scratch
    caches, and each replay advances the caller's once."""
    _card()
    model, params, prompt = _setup("hymba_1_5b", "cuda")
    step = make_lm_decode_step(model)
    g = torch.Generator("cuda").manual_seed(1)
    caches = tree_map(lambda c: torch.randn(c.shape, generator=g, device="cuda").to(c.dtype),
                      model.init_caches(B, STEPS, dtype=torch.float32, device="cuda"))
    for t in range(3):
        want = tree_map(torch.clone, caches)
        want_logits, want = torch.no_grad()(model.decode_step)(params, prompt[:, t : t + 1], want, t)
        logits, caches = step(params, prompt[:, t : t + 1], caches, t)
        torch.testing.assert_close(logits, want_logits, atol=1e-6, rtol=0)
        for a, b in zip(tree_leaves(caches["ssm"]), tree_leaves(want["ssm"])):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert len(step.graphs) == 1


@pytest.mark.cuda
def test_card_capture_with_a_host_sync_raises_naming_the_model(monkeypatch):
    _card()
    model, params, prompt = _setup("gemma2_2b", "cuda")
    cls = type(model)
    inner = cls.decode_step

    def syncing(self, p, token, caches, t):
        if token.sum().item() < -1:  # a branch on a tensor value
            token = token + 0
        return inner(self, p, token, caches, t)

    monkeypatch.setattr(cls, "decode_step", syncing)
    step = make_lm_decode_step(model)
    with pytest.raises(RuntimeError, match=r"CUDA-graph capture of the decode step of gemma2.* failed"):
        step(params, prompt[:, :1], model.init_caches(B, STEPS, dtype=torch.float32, device="cuda"), 0)
