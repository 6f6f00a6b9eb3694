"""The port's ContinuousScheduler over its PagedKVEngine (CPU, plain kernel
versions) vs the JAX scheduler over the JAX PagedKVEngine.

Both sides run the workloads of ``tests/test_scheduler.py`` (and one of
the pressure ladder) on the same JAX-initialised weights, carried
bit-exactly through ``repro_torch.models.params.from_numpy``.  The
workloads are written once against the API the two packages share
(:class:`Kit`).  What must match:

- exactly: every finished request's finish reason, ``admitted_iter``,
  ``prefill_done_iter``, ``first_token_iter``, ``finished_iter``,
  ``pf_start`` and requeue counts; ``sched.stats``; and after every
  iteration the engine's ``stats``, free list, ``PMAX``, padded page
  tables, each sequence's pages, tail length, preemption flag and
  prefix chain, ``page_codec_id``, ``request_bytes``, ``pool_pressure()``
  and the prefix cache's full ``state()`` (entries, refcounts, hits,
  SIP policy) and hit rate;
- greedy tokens, iteration by iteration: equal up to the one-bf16-ULP
  ties that ``serving/parity.GreedyParity`` reports (it fails on any
  wider mismatch).

Times never enter the comparison: the scheduler's only time source is
its telemetry clock, which feeds histograms alone.

As in ``tests/test_torch_engine.py``, the JAX side runs in a subprocess
with ``XLA_FLAGS=--xla_allow_excess_precision=false`` (with XLA's
default its jitted engine keeps bf16 intermediates in f32 and drifts
from any op-by-op implementation), and the port is held against the
JAX ``PagedKVEngine``, never ``serving/reference.py``.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro_torch.serving.parity import GreedyParity

PAGE = 8
REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the API both packages share, and what a workload records
# ---------------------------------------------------------------------------

class Kit:
    """One package's serving classes, built the same way for workloads."""

    def __init__(self, side: str, cfg, params):
        self.side, self.cfg, self.params = side, cfg, params
        if side == "jax":
            from repro.core.camp import PressureLadder
            from repro.serving import faults, snapshot
            from repro.serving.engine import PagedKVEngine
            from repro.serving.observatory import Observatory
            from repro.serving.prefix_cache import PrefixCache
            from repro.serving.reference import ReferencePagedKVEngine
            from repro.serving.scheduler import (ContinuousScheduler,
                                                 make_reference_scheduler)
            from repro.serving.telemetry import Telemetry
            from repro.serving.tier import TieredPageStore
            self._dev = {}
        else:
            from repro_torch.core.camp import PressureLadder
            from repro_torch.serving import faults, snapshot
            from repro_torch.serving.engine import PagedKVEngine
            from repro_torch.serving.observatory import Observatory
            from repro_torch.serving.prefix_cache import PrefixCache
            from repro_torch.serving.reference import ReferencePagedKVEngine
            from repro_torch.serving.scheduler import (
                ContinuousScheduler, make_reference_scheduler)
            from repro_torch.serving.telemetry import Telemetry
            from repro_torch.serving.tier import TieredPageStore
            self._dev = {"device": "cpu"}
        self.Engine, self.Scheduler = PagedKVEngine, ContinuousScheduler
        self.Reference = ReferencePagedKVEngine
        self.make_reference_scheduler = make_reference_scheduler
        self.Observatory = Observatory
        self.PrefixCache = PrefixCache
        self.PressureLadder, self.Telemetry = PressureLadder, Telemetry
        self.F, self.Tier, self._snapshot = faults, TieredPageStore, snapshot
        self.rec = Recorder(self)

    def engine(self, *, pool: int = 96, max_batch: int = 4,
               cache: bool = False, **kw):
        eng = self.Engine(self.cfg, self.params, page_size=PAGE,
                          n_pool_pages=pool, max_batch=max_batch,
                          prefix_cache=(self.PrefixCache.for_model(
                              self.cfg, PAGE) if cache else None),
                          **kw, **self._dev)
        self.rec.watch(eng)
        return eng

    def ref_engine(self, *, pool: int = 96, cache: bool = False, **kw):
        """The host-looped oracle (``serving/reference.py``), built like
        :meth:`engine`; its ``decode_one`` calls are recorded."""
        eng = self.Reference(self.cfg, self.params, page_size=PAGE,
                             n_pool_pages=pool,
                             prefix_cache=(self.PrefixCache.for_model(
                                 self.cfg, PAGE) if cache else None),
                             **kw, **self._dev)
        self.rec.watch_oracle(eng)
        return eng

    def sched(self, eng, **kw):
        return self.Scheduler(eng, **kw)

    def codec_of(self, name: str):
        pkg = "repro" if self.side == "jax" else "repro_torch"
        return __import__(f"{pkg}.codecs", fromlist=["get"]).get(name)

    def save_snapshot(self, path, eng, sched=None, *, step: int = 0):
        return self._snapshot.save_snapshot(str(path), eng, sched, step=step)

    def restore(self, path, **kw):
        """``restore_snapshot`` on this package (the CPU for the port),
        the restored engine watched by the recorder."""
        eng, sched = self._snapshot.restore_snapshot(
            str(path), self.cfg, self.params, **kw, **self._dev)
        self.rec.watch(eng)
        return eng, sched


class Recorder:
    """Tokens of every engine step (through ``mixed_step``, which every
    decode goes through), the port's logits rows beside them, and host
    states."""

    def __init__(self, kit: Kit):
        self.kit = kit
        self.steps: list[dict] = []
        self.logits: list[dict] = []
        self.states: list = []

    def watch(self, eng) -> None:
        inner = eng.mixed_step

        def mixed_step(*a, **kw):
            out, completed = inner(*a, **kw)
            self.steps.append({str(s): int(t) for s, t in out.items()})
            if self.kit.side == "port":
                self.logits.append(
                    {s: eng.last_logits[eng.seqs[s].slot].clone()
                     for s in out})
            return out, completed

        eng.mixed_step = mixed_step

    def watch_oracle(self, eng) -> None:
        """The oracle's twin of :meth:`watch`: one step per
        ``decode_one`` call."""
        inner = eng.decode_one

        def decode_one(sid):
            tok = inner(sid)
            self.steps.append({str(sid): int(tok)})
            if self.kit.side == "port":
                self.logits.append({sid: eng.last_logits[sid].clone()})
            return tok

        eng.decode_one = decode_one

    def state(self, eng, **extra) -> None:
        self.states.append(host_state(eng, **extra))


def host_state(eng, **extra) -> dict:
    cache = eng.prefix_cache
    st = {"stats": {k: int(v) for k, v in eng.stats.items()},
          "free": [int(p) for p in eng.free], "pmax": eng._pmax,
          "page_table": np.asarray(eng._page_table()).tolist(),
          "seqs": {str(sid): [[list(map(int, lp)) for lp in s.pages],
                              s.tail_len, s.preempted, list(s.chain)]
                   for sid, s in sorted(eng.seqs.items())},
          "codec_ids": [int(t) for t in eng.page_codec_id],
          "request_bytes": {str(k): [int(b) for b in v]
                            for k, v in sorted(eng.request_bytes.items())},
          "pool_pressure": eng.pool_pressure(),
          "cache": None if cache is None else cache.state(),
          "hit_rate": None if cache is None else cache.hit_rate()}
    st.update(extra)
    return st


def tracks(sched) -> dict:
    return {str(rid): {"reason": str(t.finish_reason),
                       "admitted": t.admitted_iter,
                       "prefill_done": t.prefill_done_iter,
                       "first_token": t.first_token_iter,
                       "finished": t.finished_iter, "pf_start": t.pf_start,
                       "requeues": t.requeues, "absorbed": t.absorbed,
                       "n_out": len(t.out_tokens)}
            for rid, t in sorted(sched.finished().items())}


def drive(kit: Kit, sched, arrivals: dict, *, max_iters: int = 300,
          on_step=None) -> list[dict]:
    """Open-loop drive (``tests/test_scheduler.py``'s ``_drive``): submit
    at each arrival iteration, step until drained; the engine's host
    state is recorded after every iteration."""
    pending = dict(arrivals)
    events = []
    for it in range(max_iters):
        for rid, (t, prompt, kw) in list(pending.items()):
            if t <= it:
                sched.submit(rid, list(prompt), **kw)
                del pending[rid]
        if not pending and sched.idle:
            break
        events.append(sched.step())
        kit.rec.state(sched.engine, ladder=sched.stats["ladder_level"],
                      shed=sched.engine.shed_cache_inserts)
        if on_step:
            on_step(sched, events[-1])
    assert sched.idle and not pending, "workload did not drain"
    validate = getattr(sched.engine, "debug_validate", None)
    if validate is not None:           # the JAX engine's invariant check
        validate()
    return events


def summary(sched) -> dict:
    return {"tracks": tracks(sched), "sched_stats": sched.stats,
            "engine": host_state(sched.engine)}


# ---------------------------------------------------------------------------
# workloads (tests/test_scheduler.py), each returning a JSON-able dict
# ---------------------------------------------------------------------------

def w_staggered_arrivals(kit):
    bs = kit.sched(kit.engine(), token_budget=24)
    drive(kit, bs, {
        0: (0, [5, 9, 2, 7, 11, 3], {"max_new_tokens": 9}),
        1: (2, list(range(1, 20)), {"max_new_tokens": 6}),
        2: (3, [4, 4, 8, 1], {"max_new_tokens": 11}),
        3: (7, [1 + (j * 3) % 50 for j in range(34)], {"max_new_tokens": 4}),
    })
    return summary(bs)


def w_eos_retirement(kit):
    prompt = [5, 9, 2, 7, 11, 3]
    probe = kit.sched(kit.engine(), token_budget=24)
    probe.submit(0, prompt, max_new_tokens=12)
    eos = probe.run()[0].out_tokens[3]
    bs = kit.sched(kit.engine(), token_budget=24)
    drive(kit, bs, {0: (0, prompt, {"max_new_tokens": 12, "eos_id": eos}),
                    1: (1, list(range(1, 14)), {"max_new_tokens": 8})})
    return dict(summary(bs), eos=eos)


_SPLIT_ARRIVALS = {
    0: (0, [5, 9, 2, 7, 11, 3], {"max_new_tokens": 8}),
    1: (1, [1 + (j * 3) % 50 for j in range(34)], {"max_new_tokens": 5}),
    2: (4, list(range(1, 20)), {"max_new_tokens": 6}),
}


def w_budget_boundary_chunk_splits(kit):
    bs = kit.sched(kit.engine(), token_budget=7)     # < prefill_chunk (16)
    drive(kit, bs, _SPLIT_ARRIVALS)
    wide = kit.sched(kit.engine(), token_budget=512)
    drive(kit, wide, _SPLIT_ARRIVALS)
    return {"split": summary(bs), "wide": summary(wide),
            "tokens": [{str(r): t.out_tokens for r, t in s.finished().items()}
                       for s in (bs, wide)]}


def w_camp_preemption_during_inflight_prefill(kit):
    bs = kit.sched(kit.engine(pool=17), token_budget=20)
    drive(kit, bs, {
        0: (0, [2 + (j * 7) % 40 for j in range(25)], {"max_new_tokens": 30}),
        1: (0, [3, 1, 4, 1, 5], {"max_new_tokens": 30}),
        2: (4, [3 + (j * 5) % 40 for j in range(41)], {"max_new_tokens": 4}),
    })
    return summary(bs)


def w_preempted_prefill_member_does_not_strand_cohort(kit):
    bs = kit.sched(kit.engine(pool=10), token_budget=20)
    drive(kit, bs, {
        0: (0, [3, 1, 4], {"max_new_tokens": 4}),
        1: (1, [1 + (j * 11) % 60 for j in range(72)], {"max_new_tokens": 5}),
        2: (12, [7, 3, 1, 2, 9], {"max_new_tokens": 3}),
    })
    out = summary(bs)
    out["cohort_after"] = bs.engine._cohort is None
    bs.engine.add_requests({9: [5, 9, 2, 7]})       # still operational
    out["after"] = bs.engine.decode_batch([9])
    kit.rec.state(bs.engine)
    return out


def w_empty_queue_idle_step(kit):
    bs = kit.sched(kit.engine(), token_budget=24)
    idle = [bs.step()["idle"] for _ in range(3)]
    bs.submit(0, [5, 9, 2], max_new_tokens=3)
    bs.run()
    return dict(summary(bs), idle=idle)


def w_admission_burst_larger_than_free_slots(kit):
    bs = kit.sched(kit.engine(max_batch=3), token_budget=24)
    admits = []

    def watch(sched, ev):
        if ev["admitted"]:
            admits.append(ev["admitted"])
        assert len(sched._prefill) + len(sched._running) <= 3

    drive(kit, bs, {rid: (0, [1 + (rid * 7 + j) % 50 for j in range(5 + rid)],
                          {"max_new_tokens": 3 + rid % 3})
                    for rid in range(7)}, on_step=watch)
    return dict(summary(bs), admits=admits)


def w_same_iteration_retire_and_admit(kit):
    bs = kit.sched(kit.engine(max_batch=2), token_budget=24)
    same_iter = []

    def watch(sched, ev):
        if ev["admitted"] and ev["retired"]:
            same_iter.append(ev["iteration"])

    drive(kit, bs, {0: (0, [5, 9, 2], {"max_new_tokens": 2}),
                    1: (0, [4, 4, 8, 1], {"max_new_tokens": 3}),
                    2: (1, [7, 3, 1, 2, 9], {"max_new_tokens": 3}),
                    3: (2, [2, 8, 6], {"max_new_tokens": 3})},
          on_step=watch)
    return dict(summary(bs), same_iter=same_iter)


def w_scheduler_tokens_match_blocking_engine_path(kit):
    prompt = [1 + (j * 3) % 50 for j in range(21)]
    bs = kit.sched(kit.engine(), token_budget=9)     # forces chunk splits
    bs.submit(0, prompt, max_new_tokens=7)
    sched_toks = bs.run()[0].out_tokens
    eng = kit.engine()
    eng.add_requests({0: prompt})
    plain = [eng.decode_batch([0])[0] for _ in range(7)]
    return dict(summary(bs), sched_tokens=sched_toks, plain=plain)


def w_overload_ladder_and_abort(kit):
    """The pressure ladder (``--overload``) on a small pool with a prefix
    cache: pressure climbs until insertions are shed (level 1) and the
    prefill share halves (level 2), a deadline aborts a request
    mid-flight (``engine.abort``), and pressure falls as requests
    retire.  ``pool_pressure()``, the ladder level and the shed flag are
    recorded after every iteration."""
    eng = kit.engine(pool=25, cache=True)
    bs = kit.sched(eng, token_budget=24, ladder=kit.PressureLadder())
    long = [[1 + (r * 13 + j * 7) % 90 for j in range(33)] for r in range(4)]
    drive(kit, bs, {
        0: (0, long[0], {"max_new_tokens": 10}),
        1: (1, long[1], {"max_new_tokens": 10}),
        2: (2, long[2], {"max_new_tokens": 12, "deadline": 6}),
        3: (3, long[3], {"max_new_tokens": 6}),
        4: (12, long[0][:17] + [4, 4], {"max_new_tokens": 4}),
    })
    return summary(bs)


WORKLOADS = {f.__name__[2:]: f for f in (
    w_staggered_arrivals, w_eos_retirement, w_budget_boundary_chunk_splits,
    w_camp_preemption_during_inflight_prefill,
    w_preempted_prefill_member_does_not_strand_cohort,
    w_empty_queue_idle_step, w_admission_burst_larger_than_free_slots,
    w_same_iteration_retire_and_admit,
    w_scheduler_tokens_match_blocking_engine_path,
    w_overload_ladder_and_abort)}


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

def _jax_params():
    import jax
    from repro.configs.registry import get_arch as jax_arch
    from repro.models.api import get_model
    cfg = jax_arch("yi-6b").reduced(n_layers=2, d_model=64)
    return cfg, get_model(cfg).init(jax.random.PRNGKey(0))


def jax_records_main(module: str, path: str) -> None:
    """Subprocess entry: run ``module``'s workloads on the JAX package,
    write their records as JSON to ``path``."""
    import importlib
    mod = importlib.import_module(module)
    cfg, params = _jax_params()
    out = {}
    for key, (name, kw) in mod.CASES.items():
        kit = Kit("jax", cfg, params)
        res = mod.WORKLOADS[name](kit, **kw)
        out[key] = {"result": res, "steps": kit.rec.steps,
                    "states": kit.rec.states}
    Path(path).write_text(json.dumps(out))


def run_jax_records(module: str, tmp_path_factory, **env_extra) -> dict:
    path = tmp_path_factory.mktemp("jax") / "records.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra,
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c",
                    "import test_torch_scheduler as t; "
                    f"t.jax_records_main({module!r}, {str(path)!r})"],
                   env=env, cwd=REPO, check=True, timeout=900)
    return json.loads(path.read_text())


@functools.cache
def _port_model():
    import jax
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.params import from_numpy
    _, jparams = _jax_params()
    cfg = get_arch("yi-6b").reduced(n_layers=2, d_model=64)
    return cfg, from_numpy(jax.tree.map(np.asarray, jparams))


def port_kit() -> Kit:
    return Kit("port", *_port_model())


def _norm(x):
    """JSON round trip: tuples to lists, keys to strings."""
    return json.loads(json.dumps(x))


def check_against_jax(workload, want: dict, **kw) -> tuple[Kit, dict]:
    """Run ``workload`` on the port; hold its record against the JAX one.
    Returns the port's kit and result for extra checks."""
    kit = port_kit()
    got = _norm(workload(kit, **kw))
    parity = GreedyParity()
    assert len(kit.rec.steps) == len(want["steps"])
    for step, (w, g) in enumerate(zip(want["steps"], kit.rec.steps)):
        parity.check(step, {int(k): v for k, v in w.items()},
                     {int(k): v for k, v in g.items()},
                     kit.rec.logits[step].__getitem__)
    for tie in parity.ties:                    # legitimate; show them
        print(f"{workload.__name__}: bf16 tie {tie}")
    assert not parity.ties, "a tie makes the schedules diverge: compare " \
        "host state only up to it"
    assert len(kit.rec.states) == len(want["states"])
    for i, (a, b) in enumerate(zip(_norm(kit.rec.states), want["states"])):
        assert a == b, f"host state after step {i} differs"
    assert got == want["result"]
    return kit, got


CASES = {name: (name, {}) for name in WORKLOADS}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax_records("test_torch_scheduler", tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_scheduler_matches_jax(name, jax_records):
    kit, got = check_against_jax(WORKLOADS[name], jax_records[name])
    # the properties tests/test_scheduler.py pins, on the port's run
    tr = got.get("tracks", {})
    if name == "staggered_arrivals":
        assert got["sched_stats"]["mixed_iterations"] > 0
        assert got["engine"]["free"] and not got["engine"]["seqs"]
    elif name == "eos_retirement":
        assert tr["0"]["reason"] == "eos" and tr["0"]["n_out"] <= 5
    elif name == "budget_boundary_chunk_splits":
        assert got["split"]["sched_stats"]["chunk_splits"] > 0
        assert got["wide"]["sched_stats"]["chunk_splits"] == 0
        assert got["tokens"][0] == got["tokens"][1]   # pacing, not values
    elif name == "camp_preemption_during_inflight_prefill":
        assert tr["0"]["reason"] == "preempted"
        assert tr["2"]["reason"] == "length"
        assert got["engine"]["stats"]["preemptions"] == 1
        assert (tr["2"]["admitted"] <= tr["0"]["finished"]
                <= tr["2"]["prefill_done"])
    elif name == "preempted_prefill_member_does_not_strand_cohort":
        assert tr["1"]["reason"] == "preempted"
        assert tr["1"]["first_token"] is None
        assert got["cohort_after"] and got["after"]
    elif name == "empty_queue_idle_step":
        assert got["idle"] == [True] * 3
        assert got["sched_stats"]["idle_iterations"] == 3
        assert tr["0"]["n_out"] == 3
    elif name == "admission_burst_larger_than_free_slots":
        assert got["admits"][0] == [0, 1, 2]
        assert sum(len(a) for a in got["admits"]) == 7
    elif name == "same_iteration_retire_and_admit":
        assert got["same_iter"]
    elif name == "scheduler_tokens_match_blocking_engine_path":
        assert got["sched_tokens"] == got["plain"]
    elif name == "overload_ladder_and_abort":
        st, est = got["sched_stats"], got["engine"]["stats"]
        assert st["ladder_transitions"] >= 2 and st["deadline_missed"] == 1
        assert est["shed_inserts"] > 0
        assert tr["2"]["reason"] == "deadline"
        levels = [s["ladder"] for s in kit.rec.states]
        assert max(levels) >= 1 and levels[-1] == 0


# ---------------------------------------------------------------------------
# the serve CLI's scheduler path (port only)
# ---------------------------------------------------------------------------

def test_generate_scheduler_prefix_cache_on_cpu(tmp_path):
    """``--scheduler --prefix-cache --shared-prefix 8`` end to end on the
    CPU: later arrivals hit the shared page, every request finishes by
    length, and the telemetry exports are written."""
    from repro_torch.launch.serve import generate
    paths = {k: tmp_path / f"out.{k}" for k in ("trace", "prom", "jsonl")}
    out = generate("yi-6b", smoke=True, batch=4, prompt_len=16, gen=6,
                   scheduler=True, prefix_cache=True, shared_prefix=8,
                   trace_out=str(paths["trace"]),
                   metrics_out=str(paths["prom"]),
                   metrics_jsonl=str(paths["jsonl"]), device="cpu")
    rep = out["per_request"]
    assert rep[0]["cached_tokens"] == 0
    assert all(rep[b]["cached_tokens"] == 8 for b in (1, 2, 3))
    assert {r["reason"] for r in rep.values()} == {"length"}
    assert all(r["ttft_iters"] is not None and r["compression_ratio"] > 1
               for r in rep.values())
    assert [len(t) for t in out["tokens"]] == [6] * 4
    assert out["prefix_cache"]["hits"] == 3
    assert out["sched_stats"]["prefix_cached_tokens"] == 24
    assert out["metrics_summary"]["ttft_s"]["n"] == 4
    trace = json.loads(paths["trace"].read_text())
    assert {e["ph"] for e in trace["traceEvents"]} == {"M", "X", "i", "C"}
    assert "serve_ttft_iterations" in paths["prom"].read_text()
    lines = paths["jsonl"].read_text().splitlines()
    assert json.loads(lines[-1])["final"] is True


# the CLI's observatory, audit and oracle flags, against the JAX CLI's
# ``generate`` on the same arguments (the port adds keys of its own:
# device, wall time, iteration count, per-request bytes)
_CLI_CASES = {
    "observatory": (["--scheduler", "--prefix-cache", "--shared-prefix",
                     "8", "--observatory"],
                    {"scheduler": True, "prefix_cache": True,
                     "shared_prefix": 8, "observatory": True}),
    "audit_out": (["--scheduler", "--max-queue", "1", "--arrival-stagger",
                   "0", "--audit-out", "{audit}"],
                  {"scheduler": True, "max_queue": 1, "arrival_stagger": 0,
                   "audit_out": "{audit}"}),
    "paged_reference": (["--paged-reference"], {"paged_reference": True}),
}


def _cli_record(out: dict, audit: str | None) -> dict:
    kinds = None
    if audit is not None:
        with open(audit) as f:
            kinds = sorted({json.loads(ln)["kind"] for ln in f})
    return {"keys": sorted(out), "stats": sorted(out["stats"]),
            "observatory": (sorted(out["observatory"]) if "observatory"
                            in out else None),
            "audit_kinds": kinds, "n_tokens": [len(t) for t in out["tokens"]]}


def jax_cli_main(path: str) -> None:
    """Subprocess entry: the JAX CLI's ``generate`` on each case."""
    from repro.launch.serve import generate
    rec = {}
    for name, (_, kw) in _CLI_CASES.items():
        audit = str(Path(path).with_name(f"jax_{name}.jsonl"))
        kw = {k: (audit if v == "{audit}" else v) for k, v in kw.items()}
        rec[name] = _cli_record(generate("yi-6b", **kw),
                                kw.get("audit_out"))
    Path(path).write_text(json.dumps(rec))


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_cli") / "cli.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    subprocess.run([sys.executable, "-c",
                    "import test_torch_scheduler as t; "
                    f"t.jax_cli_main({str(path)!r})"],
                   env=env, cwd=REPO, check=True, timeout=900)
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", list(_CLI_CASES))
def test_serve_cli_observatory_audit_and_oracle(name, jax_cli, monkeypatch,
                                                tmp_path, capsys):
    """``--observatory``, ``--audit-out PATH`` and ``--paged-reference``
    through the port's CLI on the CPU in smoke mode: the run's summary
    keys (the observatory's included) and the audit log's decision kinds
    equal the JAX CLI's on the same arguments."""
    from repro_torch.launch import serve
    audit = str(tmp_path / "audit.jsonl")
    flags = [audit if f == "{audit}" else f for f in _CLI_CASES[name][0]]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "yi-6b", "--smoke",
                                      "--device", "cpu"] + flags)
    captured = {}
    real = serve.generate

    def generate(*a, **kw):                 # keep the run's summary
        captured["out"] = real(*a, **kw)
        return captured["out"]

    monkeypatch.setattr(serve, "generate", generate)
    serve.main()
    printed = capsys.readouterr().out
    got = _cli_record(captured["out"],
                      audit if "--audit-out" in flags else None)
    want = jax_cli[name]
    assert set(want["keys"]) <= set(got["keys"])
    assert got["stats"] == want["stats"]
    assert got["observatory"] == want["observatory"]
    assert got["audit_kinds"] == want["audit_kinds"]
    assert got["n_tokens"] == want["n_tokens"]
    if name == "observatory":
        assert "[serve] observatory: shadow hit rates" in printed
        assert "size-bin x reuse-distance" in printed
    elif name == "audit_out":
        assert got["audit_kinds"] == ["admission_reject"]
        assert captured["out"]["sched_stats"]["rejected"] == 3
    else:
        assert captured["out"]["stats"]["pages_compressed"] > 0
