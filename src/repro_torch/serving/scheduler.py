"""Continuous-batching scheduler: token-budget mixed prefill/decode loop.

Port of ``repro/serving/scheduler.py`` (``Request``, ``Track``,
``ContinuousScheduler``) over the port's
:class:`~repro_torch.serving.engine.PagedKVEngine`.  Each iteration:

  * **admit** — waiting requests join a chunked-prefill cohort whenever
    no cohort is in flight and batch slots are free (FCFS);
  * **mix** — one decode step for every running sequence plus as many
    prefill-chunk tokens as the per-iteration ``token_budget`` allows
    (Sarathi-style: decodes always run, the leftover budget buys prefill,
    splitting a chunk at the budget boundary), through one
    ``engine.mixed_step``;
  * **retire** — sequences that emit ``eos_id`` or reach
    ``max_new_tokens`` release their pages and slot; CAMP-preempted ones
    retire as ``preempted`` or, with ``requeue_preempted=True``, re-enter
    the queue with recompute-from-prompt (the prompt grows by the tokens
    already generated; with a prefix cache most of it is a re-pin).

Prefix-cache awareness: admission reads each prompt's cached-token count
from ``begin_cohort``; a fully cached prompt skips prefill, and the
budget pays only for uncached prompt tokens.  Deadlines (in iterations),
a bounded queue and a :class:`~repro_torch.core.camp.PressureLadder`
(level 1 sheds prefix-cache inserts, level 2 halves the prefill share,
level 3 rejects submissions) control overload; a stall watchdog raises
:class:`~repro_torch.serving.faults.SchedulerStalledError`.  The
telemetry clock is the only time source here.

Decisions equal the JAX scheduler's iteration for iteration
(``tests/test_torch_scheduler.py``).  The same loop drives the
host-looped oracle (:func:`make_reference_scheduler` over
``serving/reference.py``): ``_dispatch`` then replays each iteration's
decodes one sequence at a time and advances the cohort member by member.
With an observatory on the engine, admission rejects and ladder
transitions leave decision audit records.  Faults become outcomes here: the
injector's iteration hook (free-list holds), the finish-time
``verify_seq`` (default on exactly when faults are armed), the range
check on decoded tokens, and restarts from the original prompt with
backoff up to ``max_retries`` (then ``FinishReason.CORRUPTED``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.serving.faults import FinishReason, SchedulerStalledError
from repro_torch.serving.telemetry import Telemetry


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    # deadlines in scheduler iterations from submission (None = none);
    # iteration-denominated so fault schedules stay reproducible
    ttft_deadline: int | None = None
    deadline: int | None = None


@dataclass
class Track:
    """Per-request lifecycle record (scheduler-side bookkeeping only)."""
    req: Request
    state: str                            # waiting|prefill|running|finished
    submitted_iter: int
    submitted_t: float
    admitted_iter: int | None = None
    prefill_done_iter: int | None = None
    first_token_iter: int | None = None
    first_token_t: float | None = None
    finished_iter: int | None = None
    finished_t: float | None = None
    finish_reason: str | None = None      # a FinishReason value
    last_token_t: float | None = None     # inter-token latency anchor
    out_tokens: list[int] = field(default_factory=list)
    pf_pos: int = 0                       # prompt tokens prefilled so far
    pf_start: int = 0                     # prefix-cache hit boundary
    requeues: int = 0                     # preemption requeue count
    absorbed: int = 0                     # out tokens folded into the prompt
    # integrity-recovery state: restarts recompute from orig_prompt (the
    # requeue-absorb prompt may carry corrupted-influenced tokens)
    orig_prompt: list[int] = field(default_factory=list)
    corrupt_retries: int = 0              # restarts consumed so far
    corrupt_hit: bool = False             # garbage token seen this iter


class ContinuousScheduler:
    """Token-budget continuous-batching loop over a paged-KV engine.

    ``engine`` is either a ``PagedKVEngine`` (batched mixed-step path)
    or a ``ReferencePagedKVEngine`` (sequential oracle path) — told apart
    by the presence of ``mixed_step``.
    """

    def __init__(self, engine, *, token_budget: int = 64,
                 requeue_preempted: bool = False, max_requeues: int = 3,
                 max_queue: int | None = None, ladder=None,
                 max_retries: int = 3, retry_backoff: int = 2,
                 stall_limit: int = 1000,
                 verify_finish: bool | None = None,
                 telemetry: Telemetry | None = None):
        assert token_budget >= 1, token_budget
        self.engine = engine
        self.token_budget = token_budget
        self.requeue_preempted = requeue_preempted
        self.max_requeues = max_requeues
        # -- resilience knobs (serving/faults.py) --
        self.max_queue = max_queue        # bounded-queue backpressure
        self.ladder = ladder              # core.camp.PressureLadder | None
        self.max_retries = max_retries    # integrity restarts per request
        self.retry_backoff = retry_backoff  # base delay (iterations)
        self.stall_limit = stall_limit    # watchdog threshold
        # verify page checksums when a request finishes normally: default
        # on exactly when faults are being injected (the no-fault serving
        # path pays publish-side checksumming only)
        self.verify_finish = (getattr(engine, "faults", None) is not None
                              if verify_finish is None else verify_finish)
        self._batched = hasattr(engine, "mixed_step")
        # the oracle's admission capacity and chunk width, pinned to the
        # batched engine's by make_reference_scheduler (None: unbounded)
        self._ref_max_batch: int | None = None
        self._ref_prefill_chunk = 16
        self.waiting: deque[Request] = deque()
        self.tracks: dict[int, Track] = {}
        self._prefill: list[int] = []     # rids of the in-flight cohort
        self._cohort_pos = 0              # cohort grid offset (relative)
        self._running: list[int] = []     # rids decoding, admission order
        self._delayed: list[tuple[int, int]] = []   # (ready_iter, rid)
        self._last_progress = 0
        self.iteration = 0
        # telemetry: registry-backed counters replace the old ad-hoc
        # stats dict (the `.stats` property rebuilds the same mapping),
        # plus latency histograms and the opt-in request tracer.  The
        # monotonic clock is the only time source in this file — never
        # time.time(), so an NTP step can't corrupt TTFT/deadline stats.
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.clock = self.telemetry.clock
        self.trace = self.telemetry.tracer
        reg = self.telemetry.registry
        self._m = {k: reg.counter(f"sched_{k}_total") for k in (
            "iterations", "idle_iterations", "mixed_iterations",
            "prefill_tokens", "decode_tokens", "chunk_splits",
            "requeues", "prefix_cached_tokens", "rejected",
            "deadline_missed", "corrupt_events", "corrupt_retries")}
        self._g_ladder = reg.gauge("sched_ladder_level")
        self._g_ladder_tr = reg.gauge("sched_ladder_transitions_total")
        self._g_stalled = reg.gauge("sched_stalled")
        self._g_running = reg.gauge("sched_running")
        self._g_waiting = reg.gauge("sched_waiting")
        # stats/series are labeled by the engine's page codec so serving
        # reports and bench JSONs stay comparable across codecs
        self._codec_name = getattr(getattr(engine, "codec", None),
                                   "name", "?")
        hist, cn = reg.histogram, self._codec_name
        self._h_ttft = hist("serve_ttft_seconds",
                            "submit -> first token (monotonic clock)",
                            codec=cn)
        self._h_ttft_it = hist("serve_ttft_iterations",
                               "submit -> first token, in scheduler "
                               "iterations (deterministic)", codec=cn)
        self._h_itl = hist("serve_intertoken_seconds",
                           "gap between consecutive decode tokens",
                           codec=cn)
        self._h_lat = hist("serve_request_latency_seconds",
                           "submit -> finish for requests that produced "
                           "output", codec=cn)
        self._h_lat_it = hist("serve_request_latency_iterations",
                              "submit -> finish, in iterations",
                              codec=cn)
        self._h_disp = hist("sched_dispatch_seconds",
                            "host wall time around the engine dispatch "
                            "(includes the device sync)", codec=cn)

    @property
    def stats(self) -> dict:
        """Legacy stats mapping, rebuilt from the metrics registry."""
        s = {k: m.value for k, m in self._m.items()}
        s["ladder_level"] = self._g_ladder.value
        s["ladder_transitions"] = self._g_ladder_tr.value
        s["stalled"] = bool(self._g_stalled.value)
        s["codec"] = self._codec_name
        return s

    def load_stats_dict(self, s: dict) -> None:
        """Restore counters from a legacy stats dict (snapshot compat)."""
        for k, m in self._m.items():
            if k in s:
                m.value = s[k]
        self._g_ladder.set(s.get("ladder_level", 0))
        self._g_ladder_tr.set(s.get("ladder_transitions", 0))
        self._g_stalled.set(int(s.get("stalled", False)))

    # -- queue -----------------------------------------------------------------

    def submit(self, rid: int, prompt: list[int], *,
               max_new_tokens: int = 32, eos_id: int | None = None,
               ttft_deadline: int | None = None,
               deadline: int | None = None) -> bool:
        """Enqueue a request (admission happens between iterations).

        Returns False — with the request *finished* as
        ``FinishReason.REJECTED`` — when the bounded queue is full or the
        degradation ladder is at its reject level (overload
        backpressure); True when the request entered the queue.
        """
        assert rid not in self.tracks, rid
        assert prompt, f"empty prompt for rid {rid}"
        assert max_new_tokens >= 1, max_new_tokens
        req = Request(rid, list(prompt), max_new_tokens, eos_id,
                      ttft_deadline, deadline)
        now = self.clock.now()
        tr = Track(req=req, state="waiting",
                   submitted_iter=self.iteration, submitted_t=now,
                   orig_prompt=list(prompt))
        self.tracks[rid] = tr
        if self.trace.enabled:
            self.trace.event(rid, "submit", prompt_tokens=len(prompt),
                             max_new_tokens=max_new_tokens)
            self.trace.phase(rid, "queued")
        over_queue = (self.max_queue is not None
                      and len(self.waiting) >= self.max_queue)
        shedding = self.ladder is not None \
            and self.ladder.level >= self.ladder.n_levels
        if over_queue or shedding:
            self._m["rejected"].inc()
            obs = getattr(self.engine, "obs", None)
            if obs is not None:
                obs.audit.record(
                    "admission_reject", rid=rid,
                    queue_depth=len(self.waiting),
                    max_queue=self.max_queue,
                    ladder_level=(self.ladder.level if self.ladder
                                  else 0),
                    over_queue=over_queue, shedding=shedding)
            self._finish(tr, FinishReason.REJECTED, self.iteration, now)
            return False
        self.waiting.append(req)
        return True

    def _finish(self, tr: Track, reason: str, it: int, now: float) -> None:
        """Move a track to its terminal state; one place stamps times,
        finish histograms, the per-reason counter, and the trace's
        single terminal event."""
        tr.state = "finished"
        tr.finish_reason = reason
        tr.finished_iter = it
        tr.finished_t = now
        reg = self.telemetry.registry
        reg.counter("sched_requests_finished_total",
                    "terminal requests by FinishReason",
                    reason=str(reason)).inc()
        if tr.out_tokens:                 # latency only for served work
            self._h_lat.observe(now - tr.submitted_t)
            self._h_lat_it.observe(it - tr.submitted_iter)
        self.trace.finish(tr.req.rid, reason)

    @property
    def idle(self) -> bool:
        """True when nothing is waiting, prefilling, decoding, or in
        retry backoff."""
        return not (self.waiting or self._prefill or self._running
                    or self._delayed)

    def finished(self) -> dict[int, Track]:
        return {rid: t for rid, t in self.tracks.items()
                if t.state == "finished"}

    # -- one iteration ---------------------------------------------------------

    def step(self) -> dict:
        """Run one scheduler iteration: admit → mixed dispatch → retire.

        Returns an event dict: ``admitted`` rids, ``decoded`` {rid: tok},
        ``prefilled`` token count, ``completed_prefills`` rids,
        ``retired`` [(rid, reason)], and ``idle``.
        """
        it = self.iteration
        faults = getattr(self.engine, "faults", None)
        if faults is not None:
            faults.on_iteration(self.engine, it)
        released = self._release_delayed(it)
        expired = self._expire_deadlines(it)
        if self.ladder is not None:
            prev_lvl = self._g_ladder.value
            pressure = self.engine.pool_pressure()
            lvl = self.ladder.update(pressure)
            # level 1: shed prefix-cache insertions (engine-side)
            self.engine.shed_cache_inserts = lvl >= 1
            self._g_ladder.set(lvl)
            self._g_ladder_tr.set(self.ladder.transitions)
            if lvl != prev_lvl:
                if self.trace.enabled:
                    self.trace.event(None, "ladder_transition", level=lvl,
                                     prev=prev_lvl)
                obs = getattr(self.engine, "obs", None)
                if obs is not None:
                    obs.audit.record("ladder_transition", iteration=it,
                                     level=lvl, prev=prev_lvl,
                                     pressure=round(pressure, 6))
        admitted = self._admit()
        decode_rids = list(self._running)
        n_pf = self._plan_prefill_tokens(len(decode_rids))
        self._g_running.set(len(self._running))
        self._g_waiting.set(len(self.waiting))
        if not decode_rids and n_pf == 0:
            self._check_stall(it, bool(admitted or released or expired))
            self.iteration += 1
            self._m["iterations"].inc()
            self._m["idle_iterations"].inc()
            if self.trace.enabled:
                self._trace_iteration(it, {}, 0, 0.0)
            return {"iteration": it, "admitted": admitted, "decoded": {},
                    "prefilled": 0, "completed_prefills": [],
                    "retired": expired, "idle": True}

        # host wall time around the whole dispatch: the decode post-step
        # copies the step's tokens to the host (a device sync), so this
        # span is submit-to-sync, not just call overhead
        t_disp = self.clock.now()
        out, completed = self._dispatch(decode_rids, n_pf)
        dispatch_s = self.clock.now() - t_disp
        self._h_disp.observe(dispatch_s)
        self._validate_tokens(out)

        now = self.clock.now()
        for rid, tok in out.items():
            tr = self.tracks[rid]
            tr.out_tokens.append(tok)
            if tr.first_token_iter is None:
                tr.first_token_iter = it
                tr.first_token_t = now
                self._h_ttft.observe(now - tr.submitted_t)
                self._h_ttft_it.observe(it - tr.submitted_iter)
                if self.trace.enabled:
                    self.trace.event(rid, "first_token", token=tok)
            else:
                if tr.last_token_t is not None:
                    self._h_itl.observe(now - tr.last_token_t)
                if self.trace.enabled:
                    self.trace.event(rid, "decode_token", token=tok)
            tr.last_token_t = now
        self._m["decode_tokens"].inc(len(out))
        self._m["prefill_tokens"].inc(n_pf)
        if decode_rids and n_pf:
            self._m["mixed_iterations"].inc()
        if n_pf and self.trace.enabled:
            for rid in self._prefill:
                self.trace.event(rid, "prefill_chunk", tokens=n_pf,
                                 pf_pos=self.tracks[rid].pf_pos)

        for rid in completed:
            tr = self.tracks[rid]
            if tr.state != "prefill":     # e.g. preempted + retired earlier
                continue
            tr.state = "running"
            tr.prefill_done_iter = it
            self._running.append(rid)
            if self.trace.enabled:
                self.trace.event(rid, "prefill_done")
                self.trace.phase(rid, "decode")
        self._prefill = [r for r in self._prefill if r not in completed]

        retired = self._retire(out, now)
        self._check_stall(it, True)       # a dispatch ran: progress
        self.iteration += 1
        self._m["iterations"].inc()
        if self.trace.enabled:
            self._trace_iteration(it, out, n_pf, dispatch_s)
        return {"iteration": it, "admitted": admitted, "decoded": out,
                "prefilled": n_pf, "completed_prefills": completed,
                "retired": expired + retired, "idle": False}

    def _trace_iteration(self, it: int, out: dict, n_pf: int,
                         dispatch_s: float) -> None:
        """One timeline sample: budget split, dispatch wall time, queue
        depths, pool occupancy / free-list depth."""
        eng = self.engine
        series = {"decode_tokens": len(out), "prefill_tokens": n_pf,
                  "token_budget": self.token_budget,
                  "running": len(self._running),
                  "waiting": len(self.waiting),
                  "prefill_cohort": len(self._prefill),
                  "dispatch_ms": dispatch_s * 1e3}
        series["pool_used_pages"] = eng.pool_used_pages()
        series["free_list_depth"] = len(eng.free)
        if self.ladder is not None:
            series["ladder_level"] = self._g_ladder.value
        self.trace.iteration(it, **series)

    def run(self, *, max_iterations: int = 100_000) -> dict[int, Track]:
        """Drive iterations until every submitted request finishes.

        Raises :class:`SchedulerStalledError` (with ``stats["stalled"]``
        set) instead of spinning silently — either from the per-iteration
        watchdog or on hitting ``max_iterations`` undrained."""
        for _ in range(max_iterations):
            if self.idle:
                break
            self.step()
        if not self.idle:
            self._g_stalled.set(1)
            raise SchedulerStalledError(
                f"not drained after {max_iterations} iterations")
        return self.finished()

    # -- resilience phases -----------------------------------------------------

    def _release_delayed(self, it: int) -> list[int]:
        """Move retry-backoff requests whose delay elapsed back to the
        *front* of the waiting queue (they arrived earliest)."""
        if not self._delayed:
            return []
        ready = sorted(e for e in self._delayed if e[0] <= it)
        if not ready:
            return []
        self._delayed = [e for e in self._delayed if e[0] > it]
        self.waiting.extendleft(self.tracks[rid].req
                                for _, rid in reversed(ready))
        if self.trace.enabled:
            for _, rid in ready:
                self.trace.event(rid, "backoff_released")
                self.trace.phase(rid, "queued")
        return [rid for _, rid in ready]

    def _expire_deadlines(self, it: int) -> list[tuple[int, str]]:
        """Finish every request past its TTFT or total deadline, in any
        state (waiting, backoff, prefill, running)."""
        expired: list[tuple[int, str]] = []
        for rid, tr in self.tracks.items():
            if tr.state == "finished":
                continue
            r = tr.req
            age = it - tr.submitted_iter
            miss = (r.deadline is not None and age >= r.deadline) or \
                (r.ttft_deadline is not None and tr.first_token_iter is None
                 and age >= r.ttft_deadline)
            if miss:
                expired.append((rid, FinishReason.DEADLINE))
        now = self.clock.now()
        for rid, reason in expired:
            tr = self.tracks[rid]
            if tr.state == "waiting":
                if tr.req in self.waiting:
                    self.waiting.remove(tr.req)
                self._delayed = [e for e in self._delayed if e[1] != rid]
            else:                         # mid-prefill or decoding
                if rid in self.engine.seqs:
                    self.engine.abort(rid)
                self._detach(rid)
            self._m["deadline_missed"].inc()
            if self.trace.enabled:
                self.trace.event(rid, "deadline_miss",
                                 age=it - tr.submitted_iter)
            self._finish(tr, reason, it, now)
        return expired

    def _validate_tokens(self, out: dict[int, int]) -> None:
        """Drop out-of-vocabulary decode results (the NaN-logit fault
        model) the same iteration they appear — a garbage token must
        never count as output or satisfy a finish condition."""
        vocab = self.engine.cfg.vocab
        for rid in [r for r, t in out.items() if not 0 <= t < vocab]:
            self.tracks[rid].corrupt_hit = True
            self._m["corrupt_events"].inc()
            if self.trace.enabled:
                self.trace.event(rid, "corrupt_token")
            del out[rid]

    def _check_stall(self, it: int, progress: bool) -> None:
        if progress:
            self._last_progress = it
        elif not self.idle \
                and it - self._last_progress >= self.stall_limit:
            self._g_stalled.set(1)
            raise SchedulerStalledError(
                f"no request progressed for {self.stall_limit} iterations "
                f"(waiting {len(self.waiting)}, prefill "
                f"{len(self._prefill)}, running {len(self._running)}, "
                f"delayed {len(self._delayed)})")

    # -- phases ----------------------------------------------------------------

    def _admit(self) -> list[int]:
        """Pull waiting requests into a new prefill cohort (FCFS).

        Only when no cohort is in flight — cohort members share one chunk
        grid.  An admission burst larger than the engine's free slots
        admits what fits; the rest keeps waiting.  Prefix-cache hits
        shorten each member's grid (per-row start offsets); a *full* hit
        skips the prefill phase entirely and starts decoding this very
        iteration.
        """
        if self._prefill or not self.waiting:
            return []
        if self.ladder is not None \
                and self.ladder.level >= self.ladder.n_levels:
            return []                     # overload: admissions paused
        if self._batched:
            free = len(self.engine._free_slots)
        elif self._ref_max_batch is None:
            free = len(self.waiting)          # unconstrained
        else:
            free = self._ref_max_batch - len(self.engine.seqs)
        cohort: list[Request] = []
        while self.waiting and len(cohort) < free:
            cohort.append(self.waiting.popleft())
        if not cohort:
            return []
        prompts = {r.rid: r.prompt for r in cohort}
        if self._batched:
            starts = self.engine.begin_cohort(prompts)
        else:
            starts = {rid: self.engine.begin_request(rid, prompt)
                      for rid, prompt in prompts.items()}
        for r in cohort:
            tr = self.tracks[r.rid]
            tr.admitted_iter = self.iteration
            tr.pf_start = starts[r.rid]
            tr.pf_pos = starts[r.rid]
            self._m["prefix_cached_tokens"].inc(starts[r.rid])
            if self.trace.enabled:
                self.trace.event(r.rid, "admitted",
                                 cached_tokens=starts[r.rid])
                if starts[r.rid] > 0:
                    self.trace.event(r.rid, "cache_hit",
                                     tokens=starts[r.rid])
            if starts[r.rid] >= len(r.prompt) - 1:
                tr.state = "running"          # full hit: no prefill phase
                tr.prefill_done_iter = self.iteration
                self._running.append(r.rid)
                self.trace.phase(r.rid, "decode")
            else:
                tr.state = "prefill"
                self._prefill.append(r.rid)
                self.trace.phase(r.rid, "prefill")
        self._cohort_pos = 0
        return [r.rid for r in cohort]

    def set_reference_max_batch(self, max_batch: int) -> None:
        """Pin the oracle's admission capacity to the batched engine's
        ``max_batch`` so both produce the same schedule."""
        self._ref_max_batch = max_batch

    def set_reference_prefill_chunk(self, chunk: int) -> None:
        """Pin the oracle's chunk width to the batched engine's."""
        self._ref_prefill_chunk = chunk

    def _plan_prefill_tokens(self, n_decodes: int) -> int:
        """Budget the iteration's prefill-chunk width (Sarathi packing).

        Every running sequence costs one budget token; the remainder buys
        prefill-grid tokens, splitting a chunk at the budget boundary.
        The cohort advances one *relative* grid from per-member start
        offsets, so one grid token costs one budget token per member
        still short of that grid position — cached prompt tokens were
        never entered into the grid and cost nothing.
        """
        if not self._prefill:
            return 0
        budget = max(0, self.token_budget - n_decodes)
        if budget and self.ladder is not None and self.ladder.level >= 2:
            budget = max(1, budget // 2)  # degradation: shrink prefill share
        if budget == 0:
            return 0
        chunk = (self.engine.prefill_chunk if self._batched
                 else self._ref_prefill_chunk)
        off = self._cohort_pos
        rems = [len(self.tracks[r].req.prompt) - 1
                - self.tracks[r].pf_start - off for r in self._prefill]
        rems = [r for r in rems if r > 0]
        if not rems:
            return 0

        def cost(n: int) -> int:
            return sum(min(n, r) for r in rems)

        n = min(chunk, max(rems))
        while n > 0 and cost(n) > budget:
            n -= 1
        # forward-progress floor: a cohort wider than the leftover budget
        # still advances one grid token (the budget is a packing target,
        # not a hard cap), else prefill could starve forever
        n = max(n, 1)
        if n < min(chunk, max(rems)):
            self._m["chunk_splits"].inc()
        return n

    def _dispatch(self, decode_rids: list[int], n_pf: int
                  ) -> tuple[dict[int, int], list[int]]:
        """Run the iteration's compute and advance prefill bookkeeping."""
        if self._batched:
            out, completed = self.engine.mixed_step(decode_rids, n_pf)
        else:
            # oracle replay of the same iteration: decodes first (the
            # batched step publishes decode tails before prefill pages),
            # then the cohort's chunk, member by member in cohort order
            out = {}
            for rid in decode_rids:
                seq = self.engine.seqs.get(rid)
                if seq is None or seq.preempted or seq.done:
                    continue
                out[rid] = self.engine.decode_one(rid)
            completed = []
            if n_pf > 0:
                for rid in self._prefill:
                    if (rid in self.engine.seqs
                            and self.engine.prefill_advance(rid, n_pf)):
                        completed.append(rid)
        # scheduler-side progress mirror (drives the budget planner)
        if n_pf > 0:
            self._cohort_pos += n_pf
            for rid in self._prefill:
                tr = self.tracks[rid]
                tr.pf_pos = min(tr.pf_start + self._cohort_pos,
                                len(tr.req.prompt) - 1)
        return out, completed

    def _retire(self, decoded: dict[int, int], now: float
                ) -> list[tuple[int, str]]:
        """EOS / length / preemption retirement; frees pages and slots.

        With ``requeue_preempted``, a CAMP-preempted request that still
        has work left re-enters the waiting queue instead of finishing:
        its prompt absorbs the tokens generated so far
        (recompute-from-prompt) and admission re-prefills it — which,
        with a prefix cache, re-pins whatever pages survived eviction.
        Requeued requests go to the queue *front* (they arrived
        earliest); ``max_requeues`` bounds preemption livelock.
        """
        retired: list[tuple[int, str]] = []
        requeued: list[int] = []
        restarted: list[int] = []
        for rid in list(self._running):
            tr = self.tracks[rid]
            seq = self.engine.seqs.get(rid)
            eos_hit = rid in decoded and tr.req.eos_id is not None \
                and decoded[rid] == tr.req.eos_id
            len_hit = len(tr.out_tokens) >= tr.req.max_new_tokens
            # corruption first: a garbage token or a failed integrity
            # check invalidates every other outcome this iteration
            corrupt = tr.corrupt_hit \
                or (seq is not None and getattr(seq, "corrupted", False))
            if not corrupt and (eos_hit or len_hit) and self.verify_finish \
                    and seq is not None and not seq.preempted:
                # final trust boundary: checksum the pages that produced
                # this answer before declaring it finished
                corrupt = not self.engine.verify_seq(rid)
                if corrupt:
                    self._m["corrupt_events"].inc()
            if corrupt:
                if tr.corrupt_retries < self.max_retries:
                    restarted.append(rid)
                else:
                    retired.append((rid, FinishReason.CORRUPTED))
            elif seq is not None and seq.preempted:
                if eos_hit:                   # work already complete
                    retired.append((rid, FinishReason.EOS))
                elif len_hit:
                    retired.append((rid, FinishReason.LENGTH))
                elif self.requeue_preempted \
                        and tr.requeues < self.max_requeues:
                    requeued.append(rid)
                else:
                    retired.append((rid, FinishReason.PREEMPTED))
            elif eos_hit:
                retired.append((rid, FinishReason.EOS))
            elif len_hit:
                retired.append((rid, FinishReason.LENGTH))
        for rid in list(self._prefill):
            seq = self.engine.seqs.get(rid)
            if seq is None:
                continue
            tr = self.tracks[rid]
            if getattr(seq, "corrupted", False):
                if tr.corrupt_retries < self.max_retries:
                    restarted.append(rid)
                else:
                    retired.append((rid, FinishReason.CORRUPTED))
            elif seq.preempted:
                if self.requeue_preempted \
                        and tr.requeues < self.max_requeues:
                    requeued.append(rid)
                else:
                    retired.append((rid, FinishReason.PREEMPTED))
        for rid, reason in retired:
            tr = self.tracks[rid]
            if self.trace.enabled and reason == FinishReason.PREEMPTED:
                self.trace.event(rid, "preempt")
            self._finish(tr, reason, self.iteration, now)
            self._detach(rid)
        for rid in requeued:
            tr = self.tracks[rid]
            self._detach(rid)
            # recompute-from-prompt: fold the not-yet-absorbed output
            # tokens into the prompt so re-prefill reconstructs the full
            # sequence state (prompt pages re-enter the prefix cache)
            tr.req.prompt.extend(tr.out_tokens[tr.absorbed:])
            tr.absorbed = len(tr.out_tokens)
            tr.requeues += 1
            tr.state = "waiting"
            self._m["requeues"].inc()
            if self.trace.enabled:
                self.trace.event(rid, "preempt")
                self.trace.event(rid, "requeue", requeues=tr.requeues)
                self.trace.phase(rid, "queued")
        self.waiting.extendleft(self.tracks[rid].req
                                for rid in reversed(requeued))
        for rid in restarted:
            self._restart(rid)
        return retired

    def _restart(self, rid: int) -> None:
        """Integrity recovery: recompute from the *original* prompt.

        Unlike the requeue-absorb path, nothing decoded so far can be
        trusted (a corrupted page may have influenced any token), so the
        request drops all output and re-enters the queue after an
        exponential backoff delay."""
        tr = self.tracks[rid]
        tr.corrupt_retries += 1
        self._m["corrupt_retries"].inc()
        if self.trace.enabled:
            self.trace.event(rid, "corrupt_retry",
                             retry=tr.corrupt_retries)
            self.trace.phase(rid, "backoff")
        if rid in self.engine.seqs:
            self.engine.abort(rid)
        self._detach(rid)
        tr.corrupt_hit = False
        tr.req.prompt = list(tr.orig_prompt)
        tr.out_tokens = []
        tr.absorbed = 0
        tr.pf_pos = tr.pf_start = 0
        tr.first_token_iter = None
        tr.first_token_t = None
        tr.last_token_t = None
        tr.state = "waiting"
        delay = self.retry_backoff * (2 ** (tr.corrupt_retries - 1))
        self._delayed.append((self.iteration + delay, rid))

    def _detach(self, rid: int) -> None:
        if rid in self._running:
            self._running.remove(rid)
        if rid in self._prefill:
            self._prefill.remove(rid)
        if rid in self.engine.seqs:
            self.engine.release(rid)


def make_reference_scheduler(ref_engine, *, token_budget: int,
                             max_batch: int, prefill_chunk: int,
                             **kw) -> ContinuousScheduler:
    """Oracle scheduler over the host-looped reference engine, pinned to
    the batched engine's capacity and chunk width so both produce the
    same schedule (and therefore the same tokens)."""
    sched = ContinuousScheduler(ref_engine, token_budget=token_budget, **kw)
    sched.set_reference_max_batch(max_batch)
    sched.set_reference_prefill_chunk(prefill_chunk)
    return sched
