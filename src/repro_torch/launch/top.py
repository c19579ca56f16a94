"""Live fleet dashboard: scrape ``--metrics-port`` endpoints, render
replica/bucket occupancy, rates, latency quantiles, and overload /
numerical-health state.

Runs against anything that exposes the Prometheus text endpoint the
serving stack serves (``MetricsServer``) — one process or a whole
fleet::

    python -m repro_torch.launch.top 9100 9101            # live curses view
    python -m repro_torch.launch.top 127.0.0.1:9100 --once  # plain text (CI,
                                                      # bug reports)
    python -m repro_torch.launch.top dump.prom --once     # offline: a saved
                                                    # scrape file

Everything here is stdlib (``curses`` is imported lazily, only for the
live view) and nothing imports jax/numpy or the serving stack — the
dashboard must start fast and must not compete with the fleet it is
watching.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (.+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')

Samples = Dict[str, List[Tuple[Dict[str, str], float]]]


def parse_prom(text: str) -> Samples:
    """Parse Prometheus text exposition format 0.0.4 into
    ``{metric_name: [(labels, value), ...]}``.

    >>> s = parse_prom('# HELP x y\\n# TYPE x counter\\n'
    ...                'x{a="1",b="z"} 3.0\\nplain 2\\n')
    >>> s['x']
    [({'a': '1', 'b': 'z'}, 3.0)]
    >>> s['plain']
    [({}, 2.0)]
    """
    out: Samples = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                  for k, v in _LABEL.findall(raw_labels or "")}
        out.setdefault(name, []).append((labels, value))
    return out


def scrape(endpoint: str, timeout: float = 2.0) -> Samples:
    """Fetch and parse one endpoint.  Accepts a full URL, a
    ``host:port``, a bare port (→ ``127.0.0.1:port``), or a path to a
    saved ``.prom`` scrape file (offline bug-report mode)."""
    if "://" in endpoint:
        url = endpoint
    elif os.path.exists(endpoint) or endpoint.endswith(".prom"):
        with open(endpoint) as fh:
            return parse_prom(fh.read())
    else:
        hostport = endpoint if ":" in endpoint else f"127.0.0.1:{endpoint}"
        url = f"http://{hostport}/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return parse_prom(resp.read().decode("utf-8", "replace"))


def _total(samples: Samples, name: str,
           match: Optional[Dict[str, str]] = None) -> float:
    tot = 0.0
    for labels, value in samples.get(name, []):
        if match and any(labels.get(k) != v for k, v in match.items()):
            continue
        tot += value
    return tot


def _by_label(samples: Samples, name: str, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for labels, value in samples.get(name, []):
        key = labels.get(label, "")
        out[key] = out.get(key, 0.0) + value
    return out


def _quantile(samples: Samples, name: str, q: float) -> Optional[float]:
    """Quantile from cumulative ``le``-labeled histogram buckets,
    summed across replicas, linearly interpolated within the bucket."""
    cum: Dict[float, float] = {}
    for labels, value in samples.get(name + "_bucket", []):
        le = labels.get("le", "")
        bound = float("inf") if le in ("+Inf", "inf") else float(le)
        cum[bound] = cum.get(bound, 0.0) + value
    if not cum:
        return None
    bounds = sorted(cum)
    total = cum[bounds[-1]]
    if total <= 0:
        return None
    target = q * total
    prev_bound = 0.0
    prev_cum = 0.0
    for b in bounds:
        c = cum[b]
        if c >= target:
            if b == float("inf"):
                return prev_bound
            span = c - prev_cum
            frac = (target - prev_cum) / span if span > 0 else 1.0
            return prev_bound + frac * (b - prev_bound)
        prev_bound, prev_cum = b, c
    return bounds[-1]


def summarize_endpoint(samples: Samples) -> Dict[str, object]:
    """Aggregate one scrape into the dashboard's display model."""
    completed = _by_label(samples, "repro_engine_completed_total",
                          "status")
    routed = _total(samples, "repro_cluster_routed_total")
    hits = _total(samples, "repro_cluster_routed_total", {"hit": "1"})
    drift = _by_label(samples, "repro_health_drift", "family")
    buckets: List[Tuple[str, float]] = []
    for labels, value in samples.get("repro_fleet_lane_occupancy", []):
        tag = "{}/{}/K{}".format(labels.get("family", "?"),
                                 labels.get("n_pad", "?"),
                                 labels.get("k_tier", "?"))
        buckets.append((tag, value))
    buckets.sort(key=lambda kv: (-kv[1], kv[0]))
    return {
        "ticks": _total(samples, "repro_engine_ticks_total"),
        "admitted": _total(samples, "repro_engine_admitted_total"),
        "completed": completed,
        "done": sum(completed.values()),
        "queue": _total(samples, "repro_engine_queue_depth"),
        "lanes": _total(samples, "repro_engine_active_lanes"),
        "shed": _total(samples, "repro_frontend_rejected_total")
                + _total(samples, "repro_cluster_shed_total"),
        "routed": routed,
        "hit_rate": hits / routed if routed else None,
        "p50": _quantile(samples, "repro_engine_latency_seconds", 0.50),
        "p95": _quantile(samples, "repro_engine_latency_seconds", 0.95),
        "overload": _total(samples, "repro_cluster_overload_state"),
        "healthy": _total(samples, "repro_cluster_healthy_replicas"),
        "drift": {k: v for k, v in drift.items() if v},
        "quarantines": _total(samples,
                              "repro_health_quarantines_total"),
        "waste": _total(samples, "repro_fleet_sweep_waste_ratio"),
        "watermark": _total(samples, "repro_fleet_bytes_watermark"),
        "buckets": buckets,
        "incidents": _total(samples, "repro_flight_incidents"),
    }


def _fmt(v: Optional[float], unit: str = "", digits: int = 1) -> str:
    if v is None:
        return "-"
    if unit == "s":
        if v < 1e-3:
            return f"{v * 1e6:.0f}us"
        if v < 1.0:
            return f"{v * 1e3:.{digits}f}ms"
        return f"{v:.{digits}f}s"
    if unit == "B":
        for suff in ("B", "KiB", "MiB", "GiB"):
            if abs(v) < 1024 or suff == "GiB":
                return f"{v:.{digits}f}{suff}"
            v /= 1024
    return f"{v:.{digits}f}"


def render_lines(endpoint: str, info: Dict[str, object],
                 rates: Optional[Dict[str, float]] = None) -> List[str]:
    """Render one endpoint's summary as plain text lines (shared by
    ``--once`` and the curses view)."""
    rates = rates or {}
    over = "OVERLOADED" if info["overload"] else "ok"
    lines = [f"== {endpoint} ==",
             "  ticks {:.0f} ({}/s)  queue {:.0f}  lanes {:.0f}  "
             "healthy {:.0f}  state {}".format(
                 info["ticks"], _fmt(rates.get("ticks")),
                 info["queue"], info["lanes"], info["healthy"], over)]
    comp = "  ".join(f"{k}={v:.0f}" for k, v in
                     sorted(info["completed"].items())) or "none"
    lines.append(
        "  admitted {:.0f}  done {:.0f} ({}/s)  shed {:.0f}  [{}]".format(
            info["admitted"], info["done"], _fmt(rates.get("done")),
            info["shed"], comp))
    hit = info["hit_rate"]
    lines.append("  latency p50 {}  p95 {}  affinity {}".format(
        _fmt(info["p50"], "s"), _fmt(info["p95"], "s"),
        "-" if hit is None else f"{hit:.0%}"))
    drift = info["drift"]
    health = ("drifting: " + ", ".join(
        f"{k}({v:.0f})" for k, v in sorted(drift.items()))
        if drift else "no drift")
    lines.append(
        "  health: {}  quarantines {:.0f}  incidents {:.0f}".format(
            health, info["quarantines"], info["incidents"]))
    lines.append("  fleet: waste {:.1%}  watermark {}".format(
        info["waste"], _fmt(info["watermark"], "B", 0)))
    for tag, n in info["buckets"][:8]:
        bar = "#" * min(int(n), 40)
        lines.append(f"    {tag:<24} {n:>4.0f} {bar}")
    return lines


def _collect(endpoints: List[str], timeout: float
             ) -> Dict[str, Optional[Dict[str, object]]]:
    out: Dict[str, Optional[Dict[str, object]]] = {}
    for ep in endpoints:
        try:
            out[ep] = summarize_endpoint(scrape(ep, timeout))
        except Exception:
            out[ep] = None
    return out


def _rates(prev: Dict[str, object], cur: Dict[str, object],
           dt: float) -> Dict[str, float]:
    if dt <= 0:
        return {}
    return {k: (float(cur[k]) - float(prev[k])) / dt
            for k in ("ticks", "done")}


def once(endpoints: List[str], timeout: float = 2.0,
         out=None) -> int:
    """Plain-text render; exit code 1 only when every endpoint fails."""
    out = out if out is not None else sys.stdout
    infos = _collect(endpoints, timeout)
    any_ok = False
    for ep, info in infos.items():
        if info is None:
            print(f"== {ep} ==\n  scrape failed", file=out)
            continue
        any_ok = True
        print("\n".join(render_lines(ep, info)), file=out)
    return 0 if any_ok else 1


def live(endpoints: List[str], interval: float = 1.0,
         timeout: float = 2.0) -> int:
    import curses

    def _loop(stdscr):
        curses.use_default_colors()
        stdscr.nodelay(True)
        prev: Dict[str, Tuple[float, Dict[str, object]]] = {}
        while True:
            now = time.monotonic()
            infos = _collect(endpoints, timeout)
            stdscr.erase()
            row = 0

            def put(text: str) -> None:
                nonlocal row
                try:
                    stdscr.addstr(row, 0, text)
                except curses.error:
                    pass
                row += 1

            put("repro top — {} endpoint(s) — q to quit".format(
                len(endpoints)))
            for ep, info in infos.items():
                if info is None:
                    put(f"== {ep} ==  scrape failed")
                    continue
                rates = {}
                if ep in prev:
                    t0, p = prev[ep]
                    rates = _rates(p, info, now - t0)
                prev[ep] = (now, info)
                for line in render_lines(ep, info, rates):
                    put(line)
            stdscr.refresh()
            deadline = time.monotonic() + interval
            while time.monotonic() < deadline:
                ch = stdscr.getch()
                if ch in (ord("q"), 27):
                    return 0
                time.sleep(0.05)

    return curses.wrapper(_loop)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-top",
        description="live dashboard over repro metrics endpoints")
    ap.add_argument("endpoints", nargs="+",
                    help="port, host:port, URL, or saved .prom file")
    ap.add_argument("--once", action="store_true",
                    help="plain-text render and exit (CI, bug reports)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="live refresh seconds")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-scrape timeout seconds")
    args = ap.parse_args(argv)
    if args.once:
        return once(args.endpoints, timeout=args.timeout)
    return live(args.endpoints, interval=args.interval,
                timeout=args.timeout)


if __name__ == "__main__":
    raise SystemExit(main())
