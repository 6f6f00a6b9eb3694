"""The port's copies of the numpy-only core modules, and its quickstart.

``repro_torch.core.{bdi_exact, patterns, camp, toggle, prior}`` are
copies of ``repro.core``'s (the port imports nothing of ``repro``); on
the quickstart's workloads they give the JAX package's results exactly.
``repro_torch.launch.quickstart`` runs to its end on the CPU.
"""

import numpy as np
import pytest

from repro.core import bdi_exact as jbx
from repro.core import camp as jcamp
from repro.core import patterns as jpatterns
from repro.core import prior as jprior
from repro.core import toggle as jtoggle
from repro_torch.core import bdi_exact as bx
from repro_torch.core import camp, patterns, prior, toggle


def test_bdi_exact_matches_jax_package():
    lines = patterns.thesis_mix(4096, seed=0)
    np.testing.assert_array_equal(lines, jpatterns.thesis_mix(4096, seed=0))
    sizes = bx.bdi_sizes(lines)
    np.testing.assert_array_equal(sizes, jbx.bdi_sizes(lines))
    assert bx.effective_ratio(sizes) == jbx.effective_ratio(sizes)
    c, jc = bx.bdi_compress(lines), jbx.bdi_compress(lines)
    for name in c.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(c, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(bx.bdi_decompress(c), lines)
    blob = bx.compress_stream(lines)
    assert blob == jbx.compress_stream(lines)
    np.testing.assert_array_equal(bx.decompress_stream(blob),
                                  jbx.decompress_stream(blob))


@pytest.mark.parametrize("policy", ["lru", "rrip", "camp", "gcamp"])
def test_camp_matches_jax_package(policy):
    trace = camp.soplex_like_trace(n_epochs=8)
    assert trace == jcamp.soplex_like_trace(n_epochs=8)
    assert camp.run_policy(trace, policy, capacity_bytes=32 << 10) == \
        jcamp.run_policy(trace, policy, capacity_bytes=32 << 10)


def test_toggle_ec_stream_matches_jax_package():
    lines = patterns.narrow_lines(1024, seed=3)
    assert toggle.ec_stream(lines, e_toggle=4.0, e_byte=1.0) == \
        jtoggle.ec_stream(lines, e_toggle=4.0, e_byte=1.0)


def test_prior_sizes_match_jax_package():
    lines = patterns.thesis_mix(2048, seed=1)
    got, want = prior.all_algorithm_sizes(lines), \
        jprior.all_algorithm_sizes(lines)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch.launch import quickstart
    res = quickstart.main(device="cpu")
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    lines = jpatterns.thesis_mix(4096, seed=0)
    assert res["bdi_ratio"] == jbx.effective_ratio(jbx.bdi_sizes(lines))
    assert res["tile_err"] <= res["tile_bound"]
    assert res["lcp_exceptions"] == 4
