"""The port's PagedKVEngine at the shapes its decode kernel took only once
it split over 16-row slots and head groups, vs the JAX engine, on the
CPU (plain kernel versions; the kernel itself: ``chip_smoke.py`` phase
3e and ``tests/test_torch_cuda.py``).

Cases: pages of 36 rows (three slots, the last of 4 rows) and of 64 (a
split a page) at ``tests/test_torch_engine.py``'s reduced yi-6b, and 16
query heads a KV head at pages of 16, with heads of 8 (G*D 128: the
engine's bookkeeping at G 16; the two head groups that G 16 at D 128
runs on the card are held by ``chip_smoke.py`` phase 3e and
``tests/test_torch_cuda.py``).  The workload prefills three
prompts of 70 to 130 tokens and decodes 20 steps, so that every
sequence holds several compressed pages and crosses a page boundary
while decoding.  As in ``tests/test_torch_engine.py``: the same
JAX-initialised weights, the JAX side in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, host state
(``stats``, pages, tables, free list, request bytes) equal after prefill
and at the end, greedy tokens equal up to reported bf16 ties.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro_torch.configs.registry import get_arch
from repro_torch.models.params import from_numpy
from repro_torch.serving.engine import PagedKVEngine
from repro_torch.serving.parity import GreedyParity
from test_torch_engine import _assert_state_equal, _Trace

REPO = Path(__file__).resolve().parents[1]
# case -> (reduced() overrides, page)
CASES = {"page36": ({"n_layers": 2, "d_model": 64}, 36),
         "page64": ({"n_layers": 2, "d_model": 64}, 64),
         "g16": ({"n_layers": 2, "d_model": 128, "n_heads": 16,
                  "n_kv_heads": 1}, 16)}
PROMPTS = {0: 70, 1: 100, 2: 130}
STEPS = 20


def _prompt(sid: int, n: int) -> list[int]:
    return [1 + (j * (3 + 2 * sid) + sid) % 250 for j in range(n)]


def _workload(make, page: int):
    eng = make(sum(-(-(n + STEPS) // page) for n in PROMPTS.values()) + 4,
               len(PROMPTS))
    tr = _Trace(eng)
    eng.add_requests({sid: _prompt(sid, n) for sid, n in PROMPTS.items()})
    tr.state()
    for _ in range(STEPS):
        tr.step(eng.decode_batch())
    tr.state()
    return tr


def _jax_params(case: str):
    import jax
    from repro.configs.registry import get_arch as jax_arch
    from repro.models.api import get_model
    cfg = jax_arch("yi-6b").reduced(**CASES[case][0])
    return cfg, get_model(cfg).init(jax.random.PRNGKey(0))


def jax_main(path: str) -> None:
    """Subprocess entry: every case on the JAX engine, the traces as JSON
    to ``path``."""
    from repro.serving.engine import PagedKVEngine as JaxEngine
    out = {}
    for case, (_, page) in CASES.items():
        cfg, params = _jax_params(case)

        def make(n_pool_pages, max_batch, cfg=cfg, params=params, page=page):
            return JaxEngine(cfg, params, page_size=page,
                             n_pool_pages=n_pool_pages, max_batch=max_batch,
                             codec="bdi")
        tr = _workload(make, page)
        out[case] = {"steps": tr.steps, "states": tr.states}
    Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def jax_traces(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_shapes") / "traces.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c",
                    "import test_torch_engine_shapes as t; "
                    f"t.jax_main({str(path)!r})"],
                   env=env, cwd=REPO, check=True, timeout=600)
    return json.loads(path.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine_at_shape(case, jax_traces):
    import jax
    kw, page = CASES[case]
    cfg = get_arch("yi-6b").reduced(**kw)
    params = from_numpy(jax.tree.map(np.asarray, _jax_params(case)[1]))

    def make(n_pool_pages, max_batch):
        return PagedKVEngine(cfg, params, page_size=page,
                             n_pool_pages=n_pool_pages, max_batch=max_batch,
                             codec="bdi", device="cpu")

    got, want = _workload(make, page), jax_traces[case]
    assert len(got.states) == len(want["states"])
    for a, b in zip(got.states, want["states"]):
        _assert_state_equal(a, b, got.eng.codec)
    assert got.states[-1]["stats"]["pages_compressed"] >= 2 * len(PROMPTS)
    parity = GreedyParity()
    for step, (w, g) in enumerate(zip(want["steps"], got.steps)):
        parity.check(step, {int(k): v for k, v in w.items()},
                     {int(k): v for k, v in g.items()},
                     got.logits[step].__getitem__)
    for tie in parity.ties:                    # legitimate; show them
        print(f"{case}: bf16 tie {tie}")
    assert parity.compared > 0 and len(got.steps) == STEPS
