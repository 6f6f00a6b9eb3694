"""The port's PagedKVEngine (CPU, plain kernel versions) vs the JAX engine.

Both engines run the same JAX-initialised weights (carried bit-exactly
through ``repro_torch.models.params.from_numpy``) on the workloads of
``tests/test_serving_batched.py``, under the default ``bdi`` codec and,
for a subset, under each other page codec.  Host decisions must match
exactly: ``stats``, ``pool_used_pages()``, the free list, ``_pmax``,
every sequence's pages, tail length and preemption, the padded page
tables, ``page_codec_id`` and ``request_bytes``.  Greedy tokens must
match up to reported bf16 ties (``serving/parity.py``).

Byte counts follow the codec's ``ulp_stable_sizes`` (the JAX suite's
rule, ``tests/test_codecs.py:201-210`` and ``tests/conftest.py``): for
fpc and adaptive, whose sizes read exact bit patterns, decode-tail K/V
is pinned to the token and not the bit across two engines, so
``bytes_compressed`` may differ by 8 bytes per page and a request's
compressed bytes by 64; raw bytes and every other counter stay exact.
The preempting workload's victim is the finished sequence (CAMP value
-1), so it does not depend on byte counts.

The JAX side runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``.  XLA's default lets a
jitted computation keep bf16 intermediates in f32 where the code rounds
them; with that off, the jitted JAX engine rounds exactly where its code
says, which is what the port (eager PyTorch) does, and one decode step
from the same state gives bit-identical logits.  With the default, the
two engines' logits drift apart by one to two bf16 ULPs per step and
tokens flip past the one-ULP tie rule (the same cause as the JAX
engine-vs-reference failures in ``tests/test_serving_batched.py``).
The port is held against the JAX ``PagedKVEngine``, never
``serving/reference.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import generate
from repro_torch.models.params import from_numpy
from repro_torch.serving.engine import PagedKVEngine
from repro_torch.serving.parity import GreedyParity

PAGE = 8
REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# workloads, written against the API both engines share
# ---------------------------------------------------------------------------

def _host_state(eng) -> dict:
    return {"stats": {k: int(v) for k, v in eng.stats.items()},
            "pool_used": eng.pool_used_pages(), "pmax": eng._pmax,
            "free": [int(p) for p in eng.free],
            "codec_ids": [int(t) for t in eng.page_codec_id],
            "request_bytes": {str(sid): [int(b) for b in rb] for sid, rb
                              in sorted(eng.request_bytes.items())},
            "seqs": {str(sid): [[list(lp) for lp in s.pages], s.tail_len,
                                s.preempted]
                     for sid, s in sorted(eng.seqs.items())},
            "page_table": np.asarray(eng._page_table()).tolist()}


class _Trace:
    """Per-step tokens and host-state checkpoints of one workload run;
    for the port also each step's logits rows (for tie reports)."""

    def __init__(self, eng):
        self.eng = eng
        self.keep_logits = isinstance(eng, PagedKVEngine)
        self.steps, self.states, self.logits = [], [], []

    def step(self, out: dict) -> None:
        self.steps.append({str(k): int(v) for k, v in out.items()})
        if self.keep_logits:
            self.logits.append({
                sid: self.eng.last_logits[self.eng.seqs[sid].slot].clone()
                for sid in out})

    def state(self) -> None:
        self.states.append(_host_state(self.eng))


def _w_decode_batch(make):
    eng = make(96, 8)
    tr = _Trace(eng)
    for sid, p in {0: [5, 9, 2, 7, 11, 3], 1: [4, 4, 8, 1],
                   2: list(range(1, 13))}.items():
        eng.add_request(sid, p)
    tr.state()
    for _ in range(16):
        tr.step(eng.decode_batch())
    tr.state()
    return tr


def _w_page_table_growth(make):
    eng = make(64, 2)
    tr = _Trace(eng)
    eng.add_request(0, [1 + (j * 5) % 255 for j in range(62)])
    tr.state()                                 # 7 pages/layer: PMAX 8
    for _ in range(12):                        # crosses 8 pages -> PMAX 16
        tr.step({0: eng.decode_one(0)})
    tr.state()
    return tr


def _w_camp_preemption_mid_decode(make):
    e = make(24, 8)
    tr = _Trace(e)
    for sid, p in {0: [5, 9, 2, 7, 11, 3], 1: [3, 1, 4, 1, 5],
                   2: [2, 7, 1, 8, 2, 8], 3: list(range(1, 40))}.items():
        e.add_request(sid, p)
    e.seqs[3].done = True                      # CAMP value -1: the victim
    for _ in range(20):
        tr.step(e.decode_batch([0, 1, 2]))
        tr.state()
        if e.seqs[3].preempted:
            break
    for _ in range(4):                         # decode goes on after it
        tr.step(e.decode_batch([0, 1, 2]))
    tr.state()
    return tr


def _w_chunked_prefill(make):
    eng = make(96, 8)
    tr = _Trace(eng)
    eng.add_requests({0: [5, 9, 2, 7, 11, 3], 1: list(range(1, 20)),
                      2: [4, 4, 8, 1],
                      3: [1 + (j * 3) % 50 for j in range(34)]})
    tr.state()
    for _ in range(12):
        tr.step(eng.decode_batch())
    tr.state()
    return tr


def _w_preemption_mid_prefill(make):
    e = make(15, 8)
    tr = _Trace(e)
    e.add_request(0, [2 + (j * 7) % 40 for j in range(41)])
    e.seqs[0].done = True
    e.add_request(1, [3 + (j * 5) % 40 for j in range(41)])
    tr.state()
    for _ in range(6):
        tr.step(e.decode_batch([1]))
    tr.state()
    return tr


def _w_mixed_step_budget_split(make):
    """A second cohort prefills in budget-split chunks (12 of 16 tokens)
    inside the same steps that decode the first (the scheduler's path)."""
    e = make(128, 8)
    tr = _Trace(e)
    e.add_requests({0: list(range(1, 30)), 1: [5, 9, 2]})
    e.begin_cohort({2: [3 + (j * 11) % 200 for j in range(45)],
                    3: [7, 7, 1, 2, 9, 4, 4, 8, 1, 6]})
    tr.state()
    for _ in range(9):
        out, completed = e.mixed_step(pf_tokens=12)
        tr.step(out)
        tr.states.append({"completed": completed})
    tr.state()
    return tr


WORKLOADS = {
    "decode_batch": _w_decode_batch,
    "page_table_growth": _w_page_table_growth,
    "camp_preemption_mid_decode": _w_camp_preemption_mid_decode,
    "chunked_prefill_batched_admission": _w_chunked_prefill,
    "prefill_camp_preemption_mid_prefill": _w_preemption_mid_prefill,
    "mixed_step_budget_split": _w_mixed_step_budget_split,
}


# workloads run again under each other codec (the bdi runs are above)
CODEC_WORKLOADS = {
    c: ("decode_batch", "chunked_prefill_batched_admission")
    + (("camp_preemption_mid_decode",) if c in ("gbdi", "adaptive") else ())
    for c in ("zero", "raw", "fpc", "gbdi", "adaptive")}
CODEC_CASES = [f"{c}-{w}" for c, ws in CODEC_WORKLOADS.items() for w in ws]


def _jax_params():
    import jax
    from repro.configs.registry import get_arch as jax_arch
    from repro.models.api import get_model
    cfg = jax_arch("yi-6b").reduced(n_layers=2, d_model=64)
    return cfg, get_model(cfg).init(jax.random.PRNGKey(0))


def jax_traces_main(path: str) -> None:
    """Subprocess entry: run every workload on the JAX engine, write the
    traces as JSON to ``path``."""
    from repro.serving.engine import PagedKVEngine as JaxEngine
    cfg, params = _jax_params()

    def maker(codec):
        def make(n_pool_pages, max_batch):
            return JaxEngine(cfg, params, page_size=PAGE,
                             n_pool_pages=n_pool_pages, max_batch=max_batch,
                             codec=codec)
        return make

    cases = [(name, "bdi", name) for name in WORKLOADS]
    cases += [(case, *case.split("-", 1)) for case in CODEC_CASES]
    out = {}
    for key, codec, name in cases:
        tr = WORKLOADS[name](maker(codec))
        out[key] = {"steps": tr.steps, "states": tr.states}
    Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def jax_traces(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "traces.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c",
                    "import test_torch_engine as t; "
                    f"t.jax_traces_main({str(path)!r})"],
                   env=env, cwd=REPO, check=True, timeout=600)
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port_model():
    import jax
    _, jparams = _jax_params()
    cfg = get_arch("yi-6b").reduced(n_layers=2, d_model=64)
    return cfg, from_numpy(jax.tree.map(np.asarray, jparams))


def _assert_state_equal(got: dict, want: dict, codec) -> None:
    """Host state exactly equal; byte counts by ``ulp_stable_sizes``."""
    if codec.ulp_stable_sizes or "stats" not in got:
        assert got == want
        return
    got, want = dict(got), dict(want)
    gs, ws = dict(got.pop("stats")), dict(want.pop("stats"))
    gb, wb = gs.pop("bytes_compressed"), ws.pop("bytes_compressed")
    assert gs == ws
    assert abs(gb - wb) <= 8 * max(gs["pages_compressed"], 1), (gb, wb)
    grb, wrb = got.pop("request_bytes"), want.pop("request_bytes")
    assert grb.keys() == wrb.keys()
    for sid, (raw, comp) in grb.items():
        assert raw == wrb[sid][0], sid
        assert abs(comp - wrb[sid][1]) <= 64, (sid, comp, wrb[sid][1])
    assert got == want


def _check_against_jax(name: str, codec: str, want: dict, port_model):
    cfg, params = port_model

    def make(n_pool_pages, max_batch):
        return PagedKVEngine(cfg, params, page_size=PAGE,
                             n_pool_pages=n_pool_pages, max_batch=max_batch,
                             codec=codec, device="cpu")

    got = WORKLOADS[name](make)
    assert len(got.states) == len(want["states"])   # same preemption step
    for a, b in zip(got.states, want["states"]):
        _assert_state_equal(a, b, got.eng.codec)
    assert len(got.steps) == len(want["steps"])
    parity = GreedyParity()
    for step, (w, g) in enumerate(zip(want["steps"], got.steps)):
        rows = got.logits[step]
        parity.check(step, {int(k): v for k, v in w.items()},
                     {int(k): v for k, v in g.items()}, rows.__getitem__)
    for tie in parity.ties:                    # legitimate; show them
        print(f"{codec} {name}: bf16 tie {tie}")
    assert parity.compared > 0


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_engine_matches_jax_engine(name, jax_traces, port_model):
    _check_against_jax(name, "bdi", jax_traces[name], port_model)


@pytest.mark.parametrize("case", CODEC_CASES)
def test_engine_matches_jax_engine_under_codec(case, jax_traces, port_model):
    codec, name = case.split("-", 1)
    _check_against_jax(name, codec, jax_traces[case], port_model)


def test_generate_paged_smoke_on_cpu():
    """The serve CLI's paged path end to end on the CPU."""
    out = generate("yi-6b", paged=True, smoke=True, batch=2, prompt_len=11,
                   gen=9, device="cpu")
    assert [len(t) for t in out["tokens"]] == [9, 9]
    cfg = get_arch("yi-6b").reduced()
    assert all(0 <= t < cfg.vocab for seq in out["tokens"] for t in seq)
    assert out["codec"] == "bdi" and out["stats"]["preemptions"] == 0
    # 10 stored prompt tokens + 9 decoded -> 2 full pages per layer each
    assert out["stats"]["pages_compressed"] == 2 * 2 * cfg.n_layers
    assert out["kv_compression_ratio"] > 1.0
    assert out["tok_per_s"] > 0


def test_generate_gbdi_on_cpu():
    """The serve CLI under the gbdi codec end to end on the CPU."""
    out = generate("yi-6b", paged=True, smoke=True, batch=2, prompt_len=11,
                   gen=9, codec="gbdi", device="cpu")
    cfg = get_arch("yi-6b").reduced()
    assert out["codec"] == "gbdi" and out["stats"]["preemptions"] == 0
    assert [len(t) for t in out["tokens"]] == [9, 9]
    assert out["stats"]["pages_compressed"] == 2 * 2 * cfg.n_layers
    assert out["kv_compression_ratio"] > 1.0
    assert sorted(out["request_bytes"]) == [0, 1]


def test_engine_runs_are_deterministic(port_model):
    """Two port engines on the same inputs agree bit for bit (pools and
    tokens): the CPU path has no run-to-run noise to blame a tie on."""
    cfg, params = port_model
    runs = []
    for _ in range(2):
        eng = PagedKVEngine(cfg, params, page_size=PAGE, n_pool_pages=64,
                            max_batch=4, device="cpu")
        eng.add_requests({0: list(range(1, 20)), 1: [7, 3, 9]})
        toks = [eng.decode_batch() for _ in range(10)]
        runs.append((toks, eng.pools))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
