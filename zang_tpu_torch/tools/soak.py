"""Serving soak harness of the port: long-run stability evidence for the live
tier (tools/soak.py's harness over zang_tpu_torch's LiveServer).

Runs a LiveServer (serve/server.py) on the card, unless --device cpu is
given, and N continuously-draining TCP clients in one process for a
bounded wall time, and checks the operational invariants a deployment
cares about but unit tests cannot see:

  - every client keeps receiving audio for the whole run (including its
    final quarter: no slow starvation),
  - host memory stays bounded after warmup (RSS slope, not absolute size:
    first allocations front-load; leaks show up as steady growth),
  - device memory (torch.cuda.memory_allocated) stays bounded after warmup
    by the same slope rule: on the card, that is where a leak of the live
    tier's tensors would show,
  - abrupt client churn (socket drops with no goodbye, then reconnects)
    never wedges the server or strands lanes,
  - the server answers control ops (stats) throughout.

The reference's host is a single interactive SDL process (the reference's
examples/example.zig:35-83) with no serving tier, so this harness has no
reference counterpart; it guards the scale-out layer (serve/server.py,
serve/live.py).

Client threads never sleep on wall-clock between reads: the server detaches
lanes whose socket backs up past send_timeout, so pacing is block-indexed
(toggle a key every K blocks).

Usage:
    python -m zang_tpu_torch.tools.soak --seconds 300 --clients 4
    python -m zang_tpu_torch.tools.soak --seconds 60 --json
    python -m zang_tpu_torch.tools.soak --seconds 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import torch

from ..device import require_device
from ..host import instruments as ti
from ..host.live import live_device
from ..serve.server import LiveClient, LiveServer


def _rss_mb() -> float:
    """Current (not peak) resident set, in MB.

    Without /proc (non-Linux) the fallback is ru_maxrss — PEAK rss, which
    never decreases, so the slope check degrades to 'did the peak move
    after midpoint' (weaker but still leak-sensitive). Units differ too:
    Linux reports KB, macOS bytes."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak / (1024.0 * 1024.0) if sys.platform == "darwin" else peak / 1024.0


def _device_mb(dev) -> float | None:
    """Tensor memory allocated on the card, in MB; None on the CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.memory_allocated(dev) / 2 ** 20


class _ClientWorker:
    """One soak client: drain blocks continuously, toggle a key every
    `key_blocks` blocks, count everything, remember the first failure."""

    def __init__(self, host, port, key: str, key_blocks: int,
                 deadline: float, do_stats: bool = False):
        self.key = key
        self.key_blocks = key_blocks
        self.deadline = deadline
        self.do_stats = do_stats
        self.blocks = 0
        self.blocks_final_quarter = 0
        self.stats_acks = 0
        self.error: str | None = None
        self._host, self._port = host, port
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        final_quarter = self.deadline - self._duration / 4.0
        client = None
        try:
            # generous read timeout: the first block waits on the fleet's
            # first step (and, on a fresh card, the kernels' first load)
            client = LiveClient(self._host, self._port, timeout=300.0)
            down = False
            while time.monotonic() < self.deadline:
                client.read_block()
                self.blocks += 1
                if time.monotonic() >= final_quarter:
                    self.blocks_final_quarter += 1
                if self.blocks % self.key_blocks == 0:
                    down = not down
                    client.send_key(0, self.key, down)
                if self.do_stats and self.blocks % (self.key_blocks * 8) == 0:
                    st = client.stats()
                    if st.get("clients", 0) < 1:
                        raise RuntimeError(f"stats without this client: {st}")
                    self.stats_acks += 1
        except Exception as e:  # noqa: BLE001 — reported as a soak failure
            self.error = f"{type(e).__name__}: {e}"
        finally:
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def start(self, duration: float) -> None:
        self._duration = duration
        self.thread.start()


def _churn_loop(host, port, key_blocks, deadline, counters) -> None:
    """Connect, stream a while, drop the socket abruptly (no goodbye),
    reconnect fresh — the unplanned-disconnect path, repeatedly."""
    while time.monotonic() < deadline:
        try:
            client = LiveClient(host, port, timeout=300.0)
            client.send_key(0, "t", True)
            for _ in range(key_blocks * 2):
                if time.monotonic() >= deadline:
                    break
                client.read_block()
                counters["churn_blocks"] += 1
            client.sock.close()  # abrupt: no goodbye frame
            counters["churn_drops"] += 1
        except Exception as e:  # noqa: BLE001 — reported as a soak failure
            counters["churn_error"] = f"{type(e).__name__}: {e}"
            return


# ---- the report's checks, as functions of the run's series ----


def client_failures(clients) -> list:
    """clients: (error or None, blocks, blocks in the final quarter) a
    client. Every client must have received audio, and audio in the run's
    final quarter, without an error."""
    failures = []
    for i, (error, blocks, final_quarter) in enumerate(clients):
        if error:
            failures.append(f"client {i}: {error}")
        if blocks == 0:
            failures.append(f"client {i}: received no audio")
        if final_quarter == 0:
            failures.append(f"client {i}: starved in the final quarter "
                            f"({blocks} blocks total)")
    return failures


def churn_failures(churn: bool, seconds: float, drops: int, error=None) -> list:
    """The churn loop must not fail, and a run of 30 s or more must have
    completed at least one drop cycle."""
    failures = []
    if error:
        failures.append(f"churn: {error}")
    if churn and drops == 0 and seconds >= 30:
        failures.append("churn loop never completed a drop cycle")
    return failures


def slope_check(series, seconds: float, budget_mb: float, what: str = "RSS"):
    """series: (t, MB) samples in time order. Growth is the last sample
    less the first at or after the run's midpoint (the first sample if
    none is); more than budget_mb fails. Returns (post-warmup MB, end MB,
    growth MB, the failure or None)."""
    post_warm = next((s for s in series if s[0] >= seconds * 0.5), series[0])
    growth = series[-1][1] - post_warm[1]
    failure = (f"{what} grew {growth:.1f} MB after warmup (budget {budget_mb} MB) "
               "— leak-shaped" if growth > budget_mb else None)
    return post_warm[1], series[-1][1], growth, failure


def run_soak(seconds: float = 300.0, clients: int = 4, block: int = 1024,
             sample_rate: float = 48000.0, key_blocks: int = 24,
             churn: bool = True, rss_budget_mb: float = 64.0,
             verbose: bool = True, device="cuda") -> dict:
    """Run the soak on `device` (the card unless the caller asks for the
    CPU); returns a report dict with report["ok"] overall.

    rss_budget_mb bounds the allowed growth between the run's midpoint and
    its end, of host RSS and of device memory alike: generous enough for
    late allocations and caches, tight enough that a per-block or
    per-connection leak of even a few KB fails a minutes-long run. Runs
    under ~120 s tell you about crashes and starvation more than memory."""
    dev = live_device(device)
    t0 = time.monotonic()
    deadline = t0 + seconds
    keys = "qwertyuiop"
    report: dict = {"seconds": seconds, "clients": clients, "block": block,
                    "churn": churn, "device": str(dev)}
    samples: list = []  # (t, rss_mb, device_mb, total_blocks)
    counters = {"churn_blocks": 0, "churn_drops": 0}

    with LiveServer(lambda: [(ti.NiceInstrument(0.3), 2)], sample_rate,
                    port=0, initial_lanes=clients + (1 if churn else 0),
                    realtime=False, block_size=block, device=dev) as srv:
        workers = [
            _ClientWorker(srv.host, srv.port, keys[i % len(keys)],
                          key_blocks, deadline, do_stats=(i == 0))
            for i in range(clients)
        ]
        for w in workers:
            w.start(seconds)
        churn_thread = None
        if churn:
            churn_thread = threading.Thread(
                target=_churn_loop,
                args=(srv.host, srv.port, key_blocks, deadline, counters),
                daemon=True)
            churn_thread.start()

        while time.monotonic() < deadline:
            time.sleep(min(5.0, max(0.5, deadline - time.monotonic())))
            total = sum(w.blocks for w in workers)
            samples.append((time.monotonic() - t0, _rss_mb(), _device_mb(dev), total))
            if verbose:
                t, rss, dmb, _ = samples[-1]
                dtxt = "" if dmb is None else f" device={dmb:7.1f}MB"
                print(f"# soak t={t:6.1f}s rss={rss:7.1f}MB{dtxt} "
                      f"blocks={total} drops={counters['churn_drops']}",
                      flush=True)

        for w in workers:
            w.thread.join(timeout=120.0)
        if churn_thread is not None:
            churn_thread.join(timeout=120.0)
        # lane reaping is asynchronous (the render loop notices dead
        # sockets); give it a bounded moment before reading the count
        reap_deadline = time.monotonic() + 15.0
        while srv.num_clients and time.monotonic() < reap_deadline:
            time.sleep(0.2)
        report["num_clients_at_end"] = srv.num_clients

    # ---- invariants ----
    failures = client_failures(
        [(w.error, w.blocks, w.blocks_final_quarter) for w in workers])
    failures += churn_failures(churn, seconds, counters["churn_drops"],
                               counters.get("churn_error"))
    if samples:
        post, end, growth, failure = slope_check(
            [(t, rss) for t, rss, _, _ in samples], seconds, rss_budget_mb)
        report["rss_mb_post_warmup"] = round(post, 1)
        report["rss_mb_end"] = round(end, 1)
        report["rss_growth_mb"] = round(growth, 1)
        failures += [failure] if failure else []
        if dev.type == "cuda":
            post, end, growth, failure = slope_check(
                [(t, dmb) for t, _, dmb, _ in samples], seconds, rss_budget_mb,
                "device memory")
            report["device_mb_post_warmup"] = round(post, 1)
            report["device_mb_end"] = round(end, 1)
            report["device_growth_mb"] = round(growth, 1)
            failures += [failure] if failure else []

    report["blocks_per_client"] = [w.blocks for w in workers]
    report["stats_acks"] = workers[0].stats_acks if workers else 0
    report["churn_drops"] = counters["churn_drops"]
    report["churn_blocks"] = counters["churn_blocks"]
    report["audio_seconds_delivered"] = round(
        sum(w.blocks for w in workers) * block / sample_rate, 1)
    report["wall_seconds"] = round(time.monotonic() - t0, 1)
    report["failures"] = failures
    report["ok"] = not failures
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--key-blocks", type=int, default=24,
                    help="toggle the held key every N received blocks")
    ap.add_argument("--no-churn", action="store_true")
    ap.add_argument("--rss-budget-mb", type=float, default=64.0,
                    help="allowed growth after the midpoint, of RSS and of device memory")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--json", action="store_true",
                    help="print only the final JSON report")
    args = ap.parse_args(argv)
    try:
        require_device(args.device)
    except RuntimeError as e:
        print(f"soak: {e}", file=sys.stderr)
        return 1

    report = run_soak(seconds=args.seconds, clients=args.clients,
                      block=args.block, key_blocks=args.key_blocks,
                      churn=not args.no_churn,
                      rss_budget_mb=args.rss_budget_mb,
                      verbose=not args.json, device=args.device)
    print(json.dumps(report, indent=None if args.json else 1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
