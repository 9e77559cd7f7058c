"""Router replica autoscaler on the alert engine: the port of
`paddle_tpu/inference/serving/autoscaler.py`.

An `Autoscaler` attached to a `Router` subscribes to alert transitions
(`monitor.alerts.add_listener`) and:

  * on `fire` of its target rule (default `ttft_p99`, the p99-TTFT
    SLO) spawns one replica (`Router.spawn_replica()`);
  * on `resolve` drains one replica back toward `min_replicas`
    (`Router.retire_replica()`, the token-exact export path, so
    in-flight requests replay on the survivors with identical tokens).

Hysteresis lives in three places: the alert's own for/clear streaks,
the `cooldown_s` floor between any two scaling actions, and the
min/max replica clamps. One step per transition.

Telemetry: `serve/autoscale/{spawns,drains,replicas,suppressed}` and
`autoscale_up` / `autoscale_down` flight events. Armed by
`PADDLE_SERVE_AUTOSCALE` (`Router.__init__` calls `maybe_autoscale()`;
unset = no Autoscaler, no counters, no listener) or explicitly:

    scaler = Autoscaler(router, max_replicas=4).attach()
"""
from __future__ import annotations

import os
import threading
import time

from ...core import monitor as _cmon
from ...monitor import alerts as _alerts
from ...monitor import flight as _flight

__all__ = ["Autoscaler", "maybe_autoscale", "env_autoscale_rule",
           "env_min_replicas", "env_max_replicas", "env_cooldown_s"]


def env_autoscale_rule():
    """PADDLE_SERVE_AUTOSCALE — falsy/unset disarms; `1`/`on`/`true`
    arms against the default `ttft_p99` rule; any other value names
    the alert rule to scale against."""
    v = os.environ.get("PADDLE_SERVE_AUTOSCALE", "").strip()
    if not v or v.lower() in _flight._FALSY:
        return None
    if v.lower() in ("1", "on", "true"):
        return "ttft_p99"
    return v


def env_min_replicas():
    """PADDLE_SERVE_AUTOSCALE_MIN — scale-down floor (default 0 =
    keep the router's boot-time replica count)."""
    return max(0, _flight._env_int("PADDLE_SERVE_AUTOSCALE_MIN", 0))


def env_max_replicas():
    """PADDLE_SERVE_AUTOSCALE_MAX — scale-up ceiling (default 4)."""
    return max(1, _flight._env_int("PADDLE_SERVE_AUTOSCALE_MAX", 4))


def env_cooldown_s():
    """PADDLE_SERVE_AUTOSCALE_COOLDOWN_S — floor between scaling
    actions (default 30s)."""
    return max(0.0, _flight._env_float(
        "PADDLE_SERVE_AUTOSCALE_COOLDOWN_S", 30.0))


class Autoscaler:
    """Alert-transition -> replica-count controller for one Router.

    Runs entirely on the alert evaluator's notification callback (no
    thread of its own): spawn/drain are bounded-latency router calls
    and the evaluator cadence IS the control loop period."""

    def __init__(self, router, rule="ttft_p99", min_replicas=None,
                 max_replicas=None, cooldown_s=None):
        self.router = router
        self.rule = str(rule)
        boot = len(router._replicas)
        self.min_replicas = (boot if not min_replicas
                             else max(1, int(min_replicas)))
        self.max_replicas = (env_max_replicas()
                             if max_replicas is None
                             else max(1, int(max_replicas)))
        self.cooldown_s = (env_cooldown_s() if cooldown_s is None
                           else max(0.0, float(cooldown_s)))
        self._lock = threading.Lock()
        self._last_action = None
        self._attached = False

    # -- lifecycle ---------------------------------------------------
    def attach(self):
        """Subscribe to alert transitions; publishes the replicas
        gauge so a fleet scrape shows autoscaling is live."""
        if not self._attached:
            _alerts.add_listener(self._on_alert)
            self._attached = True
            _cmon.stat_set("serve/autoscale/replicas",
                           len(self.router._live()))
        return self

    def detach(self):
        if self._attached:
            _alerts.remove_listener(self._on_alert)
            self._attached = False

    def attached(self):
        return self._attached

    # -- control loop ------------------------------------------------
    def _on_alert(self, rule, transition, value):
        if rule.name != self.rule:
            return
        with self._lock:
            if transition == "fire":
                self.scale_up(value=value)
            elif transition == "resolve":
                self.scale_down(value=value)

    def _cooled(self, now):
        return (self._last_action is None
                or now - self._last_action >= self.cooldown_s)

    def scale_up(self, value=None, now=None):
        """One replica up (clamped at max_replicas, cooldown-gated).
        Returns the new replica index or None when suppressed."""
        now = time.monotonic() if now is None else now
        live = len(self.router._live())
        if live >= self.max_replicas or not self._cooled(now):
            _cmon.stat_add("serve/autoscale/suppressed", 1)
            return None
        idx = self.router.spawn_replica()
        if idx is None:       # router draining/stopped
            return None
        self._last_action = now
        _cmon.stat_add("serve/autoscale/spawns", 1)
        _cmon.stat_set("serve/autoscale/replicas",
                       len(self.router._live()))
        _flight.record("autoscale_up", replica=idx, rule=self.rule,
                       value=value)
        return idx

    def scale_down(self, value=None, now=None):
        """One replica down toward min_replicas (cooldown-gated,
        token-exact drain). Returns the retired index or None."""
        now = time.monotonic() if now is None else now
        if len(self.router._live()) <= self.min_replicas \
                or not self._cooled(now):
            return None
        try:
            idx = self.router.retire_replica()
        except RuntimeError:
            # lost the race to a failover — the fleet is already at
            # one healthy replica, nothing to drain
            return None
        self._last_action = now
        _cmon.stat_add("serve/autoscale/drains", 1)
        _cmon.stat_set("serve/autoscale/replicas",
                       len(self.router._live()))
        _flight.record("autoscale_down", replica=idx,
                       rule=self.rule, value=value)
        return idx

    def describe(self):
        return {"rule": self.rule, "attached": self._attached,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "cooldown_s": self.cooldown_s,
                "live": len(self.router._live())}


def maybe_autoscale(router):
    """Router boot hook: attach an Autoscaler iff
    PADDLE_SERVE_AUTOSCALE names/arms a rule. Disarmed -> None (no
    object, no listener, no serve/autoscale/* stats — bit-identical
    serving)."""
    rule = env_autoscale_rule()
    if rule is None:
        return None
    return Autoscaler(
        router, rule=rule,
        min_replicas=env_min_replicas() or None,
        max_replicas=env_max_replicas(),
        cooldown_s=env_cooldown_s()).attach()
