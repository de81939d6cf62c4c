"""Federation resilience layer — fault injection, retry/backoff, circuit
breakers, and the aggregator-side poisoning gate for the collect path.

The paper's premise is federation across organizational trust boundaries
(paper §2.3: the orchestrator talks to every data provider over attested
mTLS channels; §4.1: providers are independent parties that may fail,
lag, or misbehave).  Algorithm 1's ``k_n <= k`` semantics already tolerate
*absent* providers; this module adds the rest of the threat model:

  * :class:`FaultSpec` / :class:`FaultyProvider` — a deterministic
    (seeded) fault-injection harness standing in for the real-world
    failure modes of a provider WAN link and a tampering/compromised
    site: connection failures, transport timeouts, RTT jitter, sealed
    payload corruption (→ AEAD ``IntegrityError`` at the orchestrator,
    §2.3.1 integrity), replayed nonces (→ replay detection, §2.3.1), and
    outlier/poisoned relevance scores (the retrieval-side poisoning
    attack of the RAG security literature: a malicious provider inflates
    its scores so its chunks dominate context selection).
  * :class:`RetryPolicy` — bounded per-provider retries with exponential
    backoff; the backoff budget is deducted from the live collect
    ``deadline_s`` so retries can never stretch the SLO.
  * :class:`CircuitBreaker` (+ :class:`BreakerPolicy`) — per-provider
    closed/open/half-open breaker: a provider that keeps failing whole
    rounds is skipped (no round-trip cost) until a cooldown expires,
    then probed with a single half-open attempt.  Flapping providers
    stop costing a full RTT (plus retries) every round; collect degrades
    to the healthy quorum.
  * :class:`ScoreGate` — aggregator-side poisoning defense (§4.1 "only
    authorized codes", extended to authorized *behavior*): per-provider
    score calibration (z-score against the provider's own running score
    distribution, making provider-local embedding spaces comparable) and
    an outlier gate that quarantines a provider's round when its scores
    are anomalous against its own history.  Provenance tags
    (``providers`` + ``gated`` metadata) flow into ``aggregate`` /
    ``build_prompt`` so a downstream consumer can audit what was kept.
  * :class:`ProviderHealth` / ``Orchestrator.federation_stats()`` —
    per-provider attempts, retries, breaker state, faults by type, and
    drop/quarantine counts, surfaced through
    ``CFedRAGSystem.last_serve_stats`` and ``launch/serve.py``.

Invariant: with no faults injected, retries off, and the gate off, the
collect path is bit-identical to the un-hardened one (asserted in
tests/test_resilience.py) — resilience is pure overlay, never a silent
behavior change.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np


class QuorumNotMet(RuntimeError):
    """Typed quorum failure: fewer providers answered than ``quorum``
    requires.  Subclasses RuntimeError so legacy ``except RuntimeError``
    / ``match="quorum"`` call sites keep working; carries the counts so
    the serving layer can report a *degraded* result instead of dying."""

    def __init__(self, arrived: int, required: int):
        super().__init__(
            f"quorum not met: {arrived}/{required} providers answered"
        )
        self.arrived = arrived
        self.required = required


# --------------------------------------------------------------------- #
# fault injection
# --------------------------------------------------------------------- #

_FAULT_KINDS = ("conn", "timeout", "delay", "corrupt", "replay", "poison")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Deterministic fault schedule for one (or many) providers.

    Per sealed request exactly one fault kind is drawn from a seeded RNG
    (cumulative ranges over one uniform draw, so the schedule is
    reproducible across machines and independent of wall-clock):

      * ``p_conn``    — raise ``ConnectionError`` (link down)
      * ``p_timeout`` — raise ``TimeoutError`` (transport gave up)
      * ``p_delay``   — sleep a jitter in [0, ``delay_jitter_s``] then
                        answer normally (WAN jitter)
      * ``p_corrupt`` — answer, then flip a ciphertext byte (tampered /
                        corrupted sealed payload → ``IntegrityError``)
      * ``p_replay``  — answer, but return the PREVIOUS sealed response
                        (stale nonce → replay detection)
      * ``p_poison``  — answer with inflated outlier scores (retrieval
                        poisoning; the :class:`ScoreGate` target)

    ``fault_latency_s`` models the detection cost of conn/timeout faults
    (a failed connect still burns a timeout before it raises) — without
    it, a dead provider would be *cheaper* than a healthy one and a
    breaker could never win wall-clock."""

    seed: int = 0
    p_conn: float = 0.0
    p_timeout: float = 0.0
    p_delay: float = 0.0
    delay_jitter_s: float = 0.0
    p_corrupt: float = 0.0
    p_replay: float = 0.0
    p_poison: float = 0.0
    poison_scale: float = 50.0
    fault_latency_s: float = 0.0

    def rates(self) -> dict[str, float]:
        return {
            "conn": self.p_conn,
            "timeout": self.p_timeout,
            "delay": self.p_delay,
            "corrupt": self.p_corrupt,
            "replay": self.p_replay,
            "poison": self.p_poison,
        }

    @property
    def total_rate(self) -> float:
        return sum(self.rates().values())

    def __post_init__(self):
        if self.total_rate > 1.0:
            raise ValueError(f"fault rates sum to {self.total_rate} > 1")

    def rng_for(self, provider_id: int) -> np.random.Generator:
        # per-provider stream: the schedule of provider i never depends
        # on how many requests provider j handled (thread-arrival order
        # in the concurrent fan-out must not perturb the schedule)
        return np.random.default_rng((self.seed, int(provider_id)))

    @staticmethod
    def from_json(blob: str | dict) -> "FaultSpec":
        """Build from a JSON object string (the ``--fault-spec`` CLI
        surface), e.g. ``'{"seed": 0, "p_conn": 0.1, "p_corrupt": 0.05}'``."""
        d = json.loads(blob) if isinstance(blob, str) else dict(blob)
        unknown = set(d) - {f.name for f in dataclasses.fields(FaultSpec)}
        if unknown:
            raise ValueError(f"unknown FaultSpec field(s): {sorted(unknown)}")
        return FaultSpec(**d)


class FaultyProvider:
    """Deterministic fault-injection wrapper around a ``DataProvider``.

    Transparent proxy: every attribute read/write not owned by the
    wrapper forwards to the inner provider, so the orchestrator's
    channel establishment (``p.channel = ...``, ``p._orch_channel``),
    ``rpc_lock`` serialization, and ``delay_s`` transport hints all keep
    working — only ``handle_request`` is intercepted.  This replaces the
    blunt ``DataProvider.fail`` boolean (kept for back-compat) with the
    full fault taxonomy of :class:`FaultSpec`; ``faults`` counts every
    injection by kind so a harness can reconcile injected-vs-observed.

    Calls on one provider are serialized by the orchestrator's per-
    provider ``rpc_lock``, so the per-provider RNG stream makes the
    schedule reproducible regardless of fan-out interleaving."""

    _OWN = frozenset({"inner", "spec", "faults", "calls", "_rng", "_last_response"})

    def __init__(self, inner, spec: FaultSpec):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "_rng", spec.rng_for(inner.provider_id))
        object.__setattr__(self, "faults", {k: 0 for k in _FAULT_KINDS})
        object.__setattr__(self, "calls", 0)
        object.__setattr__(self, "_last_response", None)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    # ---- fault schedule ----
    def _draw(self) -> tuple[str | None, float]:
        """One fault decision per request: (kind, jitter_s).  A single
        uniform draw selects the kind (cumulative ranges keep marginal
        rates exact); a second draw sizes the jitter only when a delay
        fault fired, so the stream stays deterministic."""
        u = float(self._rng.random())
        edge = 0.0
        for kind, p in self.spec.rates().items():
            edge += p
            if u < edge:
                jitter = (
                    float(self._rng.random()) * self.spec.delay_jitter_s
                    if kind == "delay"
                    else 0.0
                )
                return kind, jitter
        return None, 0.0

    def _poisoned_response(self, nonce: bytes, sealed: bytes):
        """Handle the request like the inner provider would, but inflate
        the relevance scores before sealing: the channel is intact (the
        provider *is* the attacker), the content is poisoned — exactly
        the retrieval-side attack the aggregator's ScoreGate must catch."""
        from repro_torch.core.provider import pack, unpack  # local: avoid cycle

        inner = self.inner
        inner.n_requests += 1
        if inner.delay_s:
            time.sleep(inner.delay_s)
        req = unpack(inner.channel.open(nonce, sealed))
        out = dict(inner.retrieve(req["query_tokens"], int(req["m"])))
        scores = np.asarray(out["scores"], np.float32)
        out["scores"] = scores + np.float32(self.spec.poison_scale)
        return inner.channel.seal(pack(out))

    def handle_request(self, nonce: bytes, sealed: bytes):
        self.calls += 1
        kind, jitter = self._draw()
        if kind == "conn":
            self.faults["conn"] += 1
            if self.spec.fault_latency_s:
                time.sleep(self.spec.fault_latency_s)
            raise ConnectionError(
                f"provider {self.inner.provider_id} injected connection failure"
            )
        if kind == "timeout":
            self.faults["timeout"] += 1
            if self.spec.fault_latency_s:
                time.sleep(self.spec.fault_latency_s)
            raise TimeoutError(
                f"provider {self.inner.provider_id} injected timeout"
            )
        if kind == "delay":
            self.faults["delay"] += 1
            if jitter:
                time.sleep(jitter)
            resp = self.inner.handle_request(nonce, sealed)
        elif kind == "poison":
            self.faults["poison"] += 1
            resp = self._poisoned_response(nonce, sealed)
        else:
            resp = self.inner.handle_request(nonce, sealed)
        if kind == "corrupt":
            self.faults["corrupt"] += 1
            r_nonce, r_sealed = resp
            tampered = bytearray(r_sealed)
            tampered[len(tampered) // 2] ^= 0xFF
            return r_nonce, bytes(tampered)
        if (
            kind == "replay"
            and self._last_response is not None
            and self._last_response[0] is self.inner.channel
        ):
            # re-send the previous round's sealed response: its nonce is
            # behind the orchestrator's receive sequence -> IntegrityError.
            # Only counted while the channel that sealed it is still live:
            # after a re-establish the receive sequence resets and the old
            # message would verify again — a replay that cannot be
            # detected is not a detectable injection, so it is not drawn.
            self.faults["replay"] += 1
            return self._last_response[1]
        self._last_response = (self.inner.channel, resp)
        return resp


# --------------------------------------------------------------------- #
# retry / breaker
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded per-provider retry with exponential backoff.

    ``max_attempts`` counts total round-trips (1 == retries disabled —
    the exact legacy single-shot path).  The backoff before attempt
    ``n+1`` is ``backoff_s * backoff_mult**n``; the orchestrator deducts
    it from the remaining ``deadline_s`` budget and stops retrying when
    the SLO cannot afford another attempt."""

    max_attempts: int = 3
    backoff_s: float = 0.02
    backoff_mult: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff(self, prior_attempts: int) -> float:
        return self.backoff_s * self.backoff_mult ** max(0, prior_attempts - 1)


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Per-federation breaker parameters (one CircuitBreaker is minted
    per provider): ``fail_threshold`` consecutive failed *rounds* open
    the breaker, ``cooldown_s`` later one half-open probe is allowed."""

    fail_threshold: int = 2
    cooldown_s: float = 1.0


class CircuitBreaker:
    """Closed / open / half-open breaker for one provider.

    closed:    requests flow; ``fail_threshold`` consecutive failed
               rounds trip it open.
    open:      requests are skipped (no round-trip, no retry cost) until
               ``cooldown_s`` has elapsed.
    half-open: exactly one probe round is allowed through; success
               closes the breaker, failure re-opens it (fresh cooldown).

    Thread-safe: ``allow``/``record_*`` may race across the concurrent
    fan-out of overlapping collects."""

    def __init__(self, policy: BreakerPolicy, clock=time.monotonic):
        self.policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trips = 0  # observability: how often it opened

    @property
    def state(self) -> str:
        with self._lock:
            if (
                self._state == "open"
                and self._clock() - self._opened_at >= self.policy.cooldown_s
            ):
                return "half-open"  # next allow() will admit the probe
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at < self.policy.cooldown_s:
                    return False
                self._state = "half-open"
                self._probe_inflight = True
                return True
            # half-open: only the single probe may be in flight
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self):
        with self._lock:
            self._state = "closed"
            self._consecutive_failures = 0
            self._probe_inflight = False

    def record_failure(self):
        with self._lock:
            self._consecutive_failures += 1
            if self._state == "half-open":
                self._trip()
            elif (
                self._state == "closed"
                and self._consecutive_failures >= self.policy.fail_threshold
            ):
                self._trip()

    def _trip(self):
        self._state = "open"
        self._opened_at = self._clock()
        self._probe_inflight = False
        self.trips += 1


# --------------------------------------------------------------------- #
# per-provider health ledger
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class ProviderHealth:
    """Everything the orchestrator observed about one provider: attempts
    dispatched, successes, retries, breaker skips, channel re-
    establishments, score-gate quarantines, and faults by type."""

    attempts: int = 0
    successes: int = 0
    retries: int = 0
    skips: int = 0  # rounds not dispatched because the breaker was open
    rechannels: int = 0  # channel self-heals after IntegrityError
    quarantined: int = 0  # rounds dropped by the score gate
    dropped_chunks: int = 0  # chunks removed by quarantine
    faults: dict = dataclasses.field(
        default_factory=lambda: {"conn": 0, "timeout": 0, "integrity": 0}
    )
    breaker: CircuitBreaker | None = None

    def record_fault(self, exc: BaseException):
        if isinstance(exc, ConnectionError):
            self.faults["conn"] += 1
        elif isinstance(exc, TimeoutError):
            self.faults["timeout"] += 1
        else:
            self.faults["integrity"] += 1

    def as_dict(self) -> dict:
        d = {
            "attempts": self.attempts,
            "successes": self.successes,
            "retries": self.retries,
            "skips": self.skips,
            "rechannels": self.rechannels,
            "quarantined": self.quarantined,
            "dropped_chunks": self.dropped_chunks,
            "faults": dict(self.faults),
            "breaker": self.breaker.state if self.breaker else None,
            "breaker_trips": self.breaker.trips if self.breaker else 0,
        }
        return d


# --------------------------------------------------------------------- #
# aggregator-side poisoning gate
# --------------------------------------------------------------------- #


class ScoreGate:
    """Per-provider score calibration + outlier quarantine.

    Providers may run *different* embedding models (paper §2.3.4: each
    site vectorizes with its embedding model of choice), so raw score
    scales are not comparable across providers — and a malicious
    provider can exploit exactly that by inflating its scores to
    dominate ``aggregate``'s top-n cut.  The gate keeps a running
    per-provider score distribution (Welford mean/variance over every
    score the provider has ever returned) and, per round:

      1. **outlier gate** — if the round's max z-score against the
         provider's OWN history exceeds ``z_max`` (history permitting:
         at least ``min_history`` scores), the provider's whole round is
         quarantined (chunks dropped, counted) and the anomalous scores
         are NOT folded into the history — poisoning must not be able to
         shift its own baseline.
      2. **calibration** — surviving scores are z-scored against the
         provider's distribution, so cross-provider ranking compares
         "how unusual is this match for THIS provider" instead of raw
         cosines from incompatible spaces.

    Opt-in: the gate changes ranking inputs, so it is off by default and
    the ungated path stays bit-identical.  Thread-safe (one lock; the
    concurrent fan-out aggregates on one thread today, but overlapping
    ``serve_stream`` collectors may not)."""

    def __init__(self, z_max: float = 6.0, min_history: int = 16):
        self.z_max = z_max
        self.min_history = min_history
        self._lock = threading.Lock()
        self._stats: dict[int, tuple[int, float, float]] = {}  # pid -> (n, mean, M2)

    def _mean_std(self, pid: int) -> tuple[int, float, float]:
        n, mean, m2 = self._stats.get(pid, (0, 0.0, 0.0))
        std = (m2 / (n - 1)) ** 0.5 if n > 1 else 0.0
        return n, mean, std

    def _fold(self, pid: int, scores: np.ndarray):
        n, mean, m2 = self._stats.get(pid, (0, 0.0, 0.0))
        for x in scores.ravel():
            n += 1
            d = float(x) - mean
            mean += d / n
            m2 += d * (float(x) - mean)
        self._stats[pid] = (n, mean, m2)

    def admit(self, pid: int, scores: np.ndarray) -> tuple[bool, np.ndarray]:
        """Gate one provider's round.  Returns ``(keep, calibrated)``:
        ``keep=False`` quarantines the round (calibrated is the raw
        input, unused); ``keep=True`` returns z-scored ``calibrated``
        (identity when history is still too thin to calibrate)."""
        scores = np.asarray(scores, np.float32)
        with self._lock:
            n, mean, std = self._mean_std(pid)
            if n >= self.min_history and std > 0.0:
                z = (scores - mean) / std
                if float(np.max(np.abs(z))) > self.z_max:
                    return False, scores  # quarantine; history unpolluted
                self._fold(pid, scores)
                return True, ((scores - mean) / std).astype(np.float32)
            # cold start: observe only, rank on raw scores
            self._fold(pid, scores)
            return True, scores

    def snapshot(self) -> dict[int, dict]:
        with self._lock:
            return {
                pid: {"n": n, "mean": mean, "std": self._mean_std(pid)[2]}
                for pid, (n, mean, _) in self._stats.items()
            }
