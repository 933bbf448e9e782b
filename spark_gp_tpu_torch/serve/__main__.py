"""``python -m spark_gp_tpu_torch.serve``: JSON-lines scoring over stdin or
localhost TCP (the port's counterpart of the JAX package's serve CLI: the
same flags, ready contract and protocol, plus ``--device``).

Startup (the ready contract):

1. with ``--preflight``, probe the card in a throwaway subprocess; a card
   that does not answer ends the process with an ``{"event": "error"}``
   line and a non-zero exit (there is no CPU fallback);
2. load every ``--model name=path`` (a ``.npz`` of either package) onto
   ``--device`` (default ``cuda``; without a GPU the server refuses to
   start unless ``--device cpu`` is given) and capture each bucket's CUDA
   graph;
3. emit ``{"event": "ready", ...}``: only after this line is the hot path
   free of builds.

Protocol (one JSON object per line, in either direction):

    {"id": 1, "model": "m", "x": [[...], ...]}   -> {"id": 1, "mean": [...], "var": [...]}
    {"id": 2, "model": "m", "x": [...], "request_id": "abc"}
        -> the same, with "request_id" echoed (it is stamped on the
           server's serve.predict span and on any hang incident bundle)
    {"cmd": "metrics"}  ({"format": "openmetrics"} for the page) -> {"event": "metrics", ...}
    {"cmd": "health"}   (alias {"op": "health"}) -> {"event": "health", "status": ...}
    {"cmd": "reload", "model": "m"}  (+ "canary_fraction") -> {"event": "reloaded" | "canary", ...}
    {"cmd": "observe", "model": "m", "request_id": "abc", "y": [...]}
        -> {"event": "observed", "joined": n, "duplicate": false, "alert": ...}:
           the delayed labels of a request served with that request_id,
           graded by the model's calibration monitor (obs/quality.py)
    {"cmd": "shutdown"}  (or EOF on stdin)       -> {"event": "shutdown", ...}

``health`` answers at once, outside the ordered writer queue.  Error
replies carry a machine-readable ``code`` when the failure has one
(``serve/codes.py``).  Replies to predicts are written in submission
order by a writer thread.  SIGTERM / SIGINT drain gracefully in both
modes: new submits are rejected with ``code=queue.shed.draining``, queued
and in-flight work completes under ``--drain-deadline-s``, the last line
is ``{"event": "shutdown", "drained": true, ...}`` and the exit status 0.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import queue as _queue
import sys
import threading
from typing import Optional


def _parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="python -m spark_gp_tpu_torch.serve",
        description="online GP inference server (JSON lines on stdin or TCP)",
    )
    parser.add_argument(
        "--model", action="append", default=[], metavar="NAME=PATH",
        help="model to load and warm (repeatable)",
    )
    parser.add_argument("--max-batch", type=int, default=256,
                        help="largest batch bucket (rows)")
    parser.add_argument("--min-bucket", type=int, default=8,
                        help="smallest batch bucket (rows)")
    parser.add_argument("--mean-only", action="store_true",
                        help="serve means only (skips the O(t m^2) variance)")
    parser.add_argument("--capacity", type=int, default=1024,
                        help="request queue bound (backpressure past this)")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="micro-batch coalescing window")
    parser.add_argument("--request-timeout-ms", type=float, default=1000.0,
                        help="per-request deadline (0 disables)")
    parser.add_argument("--breaker-threshold", type=int, default=3,
                        help="consecutive predict failures that trip a "
                        "model's circuit breaker open")
    parser.add_argument("--breaker-reset-s", type=float, default=5.0,
                        help="breaker cooldown before a half-open probe")
    parser.add_argument("--drain-deadline-s", type=float, default=30.0,
                        help="graceful-drain budget on SIGTERM/SIGINT: "
                        "queued and in-flight work gets this long to "
                        "complete before leftovers are failed fast")
    parser.add_argument("--hang-timeout-s", type=float, default=30.0,
                        help="hang-watchdog deadline per device dispatch "
                        "(0 disables): past it the batch fails with "
                        "code=exec.hung and the model's breaker trips")
    parser.add_argument("--memory-limit-bytes", type=float, default=None,
                        help="memory-pressure admission limit (default: "
                        "GP_SERVE_MEMORY_LIMIT_BYTES env; unset disables): "
                        "low-priority submits are shed with "
                        "code=queue.shed.memory above the high watermark")
    parser.add_argument("--port", type=int, default=None,
                        help="serve a TCP socket on 127.0.0.1:PORT instead of stdin")
    parser.add_argument(
        "--replica-id", default=None,
        help="stable replica identity reported by the health verb "
        "(default: GP_REPLICA_ID env or a pid-derived id)",
    )
    parser.add_argument(
        "--conn-read-timeout-s", type=float, default=300.0,
        help="TCP mode: per-connection read timeout (0 disables) — a "
        "half-open or vanished client is disconnected instead of "
        "pinning a reader thread forever (code=serve.conn_idle)",
    )
    parser.add_argument(
        "--max-connections", type=int, default=64,
        help="TCP mode: concurrent-connection bound; connections past it "
        "are refused with one code=serve.conn_limit line",
    )
    parser.add_argument(
        "--quality", type=int, default=None, choices=(0, 1),
        help="statistical quality plane: the calibration and drift "
        "monitors and the observe verb (default on: GP_SERVE_QUALITY, "
        "0 turns it off)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose a plain-text OpenMetrics scrape endpoint on "
        "127.0.0.1:PORT (0 picks a free port; reported in the ready line)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the models are served (default cuda; without a GPU the "
        "server refuses to start unless --device cpu is given)",
    )
    parser.add_argument(
        "--preflight", action="store_true",
        help="probe the card in a subprocess before loading: a card that "
        "does not answer ends the server with an error event and a "
        "non-zero exit (there is no CPU fallback)",
    )
    return parser.parse_args(argv)


def _out(lock, stream, payload: dict) -> None:
    with lock:
        stream.write(json.dumps(payload) + "\n")
        stream.flush()


def _writer_loop(pending: "_queue.Queue", lock, stream, result_wait_s) -> None:
    """Emit responses in submission order — predicts and command replies
    share the one queue, so a ``metrics`` reply can never overtake the
    predict submitted just before it."""
    while True:
        item = pending.get()
        if item is None:
            return
        if isinstance(item, dict):  # pre-built command reply
            _out(lock, stream, item)
            continue
        if callable(item):  # late-bound reply (metrics snapshot at emit
            try:                     # time, after earlier predicts)
                reply = item()
            except Exception as exc:  # noqa: BLE001 — a raising render must
                # not kill the writer: every reply queued behind it would be
                # silently dropped and clients would block forever
                reply = {"error": f"{type(exc).__name__}: {exc}"[:500]}
            _out(lock, stream, reply)
            continue
        req_id, future, wait_s, request_id = item
        try:
            # every enqueued request IS eventually completed (answered,
            # deadline-expired, or shutdown-errored), so with deadlines
            # disabled an unbounded wait cannot hang — while any finite
            # cap here would spuriously error deep-queued requests and
            # head-of-line-block every reply behind them
            mean, var = future.result(
                timeout=result_wait_s if wait_s is None else wait_s
            )
            response = {
                "id": req_id,
                "mean": [float(v) for v in mean],
                "var": None if var is None else [float(v) for v in var],
            }
        except Exception as exc:  # noqa: BLE001 — per-request error surface
            response = {
                "id": req_id,
                "error": f"{type(exc).__name__}: {exc}"[:500],
            }
            code = getattr(exc, "code", None)
            if code is not None:
                response["code"] = code
        if request_id is not None:
            # echo the client's correlation id: the reply carries the same
            # handle the server-side predict span (and any incident
            # bundle) was stamped with — cross-process trace stitching
            response["request_id"] = request_id
        _out(lock, stream, response)


def _serve_stream(server, lines, out_stream, out_lock) -> bool:
    """One client session; returns True when a shutdown was requested."""
    # queue deadline + batch slack; None (wait indefinitely) when
    # per-request deadlines are disabled — see _writer_loop
    timeout_s = server.request_timeout_s
    result_wait_s = None if timeout_s is None else timeout_s + 30.0
    pending: _queue.Queue = _queue.Queue()
    writer = threading.Thread(
        target=_writer_loop,
        args=(pending, out_lock, out_stream, result_wait_s),
        daemon=True,
    )
    writer.start()
    shutdown = False
    try:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                if not isinstance(msg, dict):
                    raise ValueError("expected a JSON object")
            except ValueError as exc:
                _out(out_lock, out_stream, {"error": f"bad request line: {exc}"})
                continue
            cmd = msg.get("cmd", msg.get("op"))
            if cmd == "shutdown":
                shutdown = True
                break
            if cmd == "metrics":
                fmt = msg.get("format", "json")
                if fmt == "openmetrics":
                    # the Prometheus exposition page as one JSON field —
                    # the line protocol cannot carry raw multi-line text;
                    # scrapers wanting the bare page use --metrics-port
                    pending.put(lambda: {
                        "event": "metrics",
                        "format": "openmetrics",
                        "body": server.openmetrics(),
                    })
                elif fmt == "json":
                    pending.put(
                        lambda: {"event": "metrics", **server.snapshot()}
                    )
                else:
                    pending.put(
                        {"error": f"unknown metrics format {fmt!r}; "
                         "expected 'json' or 'openmetrics'"}
                    )
                continue
            if cmd == "health":
                # straight to the stream, NOT the ordered writer queue: a
                # liveness probe must answer even when the writer is
                # blocked behind a stalled predict backlog
                _out(out_lock, out_stream, {
                    "event": "health", **server.health()
                })
                continue
            if cmd == "observe":
                # delayed-label feedback join (obs/quality.py): cheap
                # (O(rows) numpy under the quality lock), but routed
                # through the ordered writer queue so an observation can
                # never be processed before the reply of the predict it
                # grades was emitted.  Always answered as an "observed"
                # event — success or a coded error — so wire clients can
                # route the reply without a request id.
                def _do_observe(m=msg):
                    try:
                        result = server.observe(
                            m.get("model"), m.get("request_id"), m.get("y")
                        )
                        return {"event": "observed", **result}
                    except Exception as exc:  # noqa: BLE001 — per-request
                        reply = {
                            "event": "observed",
                            "error": f"{type(exc).__name__}: {exc}"[:500],
                        }
                        code = getattr(exc, "code", None)
                        if code is not None:
                            reply["code"] = code
                        if m.get("request_id") is not None:
                            reply["request_id"] = str(m["request_id"])
                        return reply

                pending.put(_do_observe)
                continue
            if cmd == "reload":
                # on a side thread: a reload pays a full load + graph warmup,
                # and blocking the reader here would keep NEW requests from
                # even reaching the (still-serving) old version.  The reply
                # rides the pending queue, so ordering is preserved.  With
                # "canary_fraction" the reload goes through the canary gate
                # (shadow-scored slice, auto-promote/rollback) instead of
                # an instant hot swap.
                def _do_reload(m=msg):
                    try:
                        fraction = m.get("canary_fraction")
                        if fraction is not None:
                            entry = server.rollout(
                                m["model"], m.get("path"),
                                canary_fraction=float(fraction),
                            )
                            return {
                                "event": "canary",
                                "model": entry.name,
                                "version": entry.version,
                            }
                        entry = server.reload(m["model"], m.get("path"))
                        return {
                            "event": "reloaded",
                            "model": entry.name,
                            "version": entry.version,
                        }
                    except Exception as exc:  # noqa: BLE001
                        return {"error": f"reload failed: {exc}"[:500]}

                reload_future = concurrent.futures.Future()
                threading.Thread(
                    target=lambda: reload_future.set_result(_do_reload()),
                    daemon=True,
                ).start()
                pending.put(lambda: reload_future.result())
                continue
            if cmd is not None:
                pending.put({"error": f"unknown cmd {cmd!r}"})
                continue
            req_id = msg.get("id")
            # optional client correlation id: becomes the predict span's
            # request_id attribute server-side and is echoed in the reply
            request_id = msg.get("request_id")
            try:
                future = server.submit(
                    msg["model"], msg["x"],
                    version=msg.get("version"),
                    timeout_ms=msg.get("timeout_ms"),
                    # priority only matters under memory pressure: >= the
                    # gate's floor keeps being admitted while low-priority
                    # work is shed with code=queue.shed.memory
                    priority=int(msg.get("priority", 0)),
                    request_id=request_id,
                )
            except Exception as exc:  # noqa: BLE001 — shed/shape errors
                # through the writer queue, not directly: error replies
                # must not overtake earlier predicts' answers (the
                # submission-order contract)
                reply = {
                    "id": req_id,
                    "error": f"{type(exc).__name__}: {exc}"[:500],
                }
                code = getattr(exc, "code", None)
                if code is not None:
                    reply["code"] = code
                if request_id is not None:
                    reply["request_id"] = request_id
                pending.put(reply)
                continue
            # a per-request timeout_ms override also stretches the writer's
            # wait — a long-deadline request must not be errored at the
            # server-default cap while still within its own deadline
            override = msg.get("timeout_ms")
            pending.put((
                req_id, future,
                None if override is None else override / 1e3 + 30.0,
                request_id,
            ))
        if shutdown:
            # the documented reply to {"cmd": "shutdown"}, on THIS
            # session's stream (a TCP client would otherwise only see EOF)
            pending.put(lambda: {
                "event": "shutdown",
                "requests": server.metrics.counter("requests"),
                "batches": server.metrics.counter("batches"),
            })
    finally:
        pending.put(None)
        writer.join(timeout=120.0)
    return shutdown


def _serve_socket(server, port: int, out_lock, drain_flag=None,
                  read_timeout_s: float = 300.0,
                  max_connections: int = 64) -> None:
    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", port))
    sock.listen(16)
    bound = sock.getsockname()[1]
    _out(out_lock, sys.stdout, {"event": "listening", "port": bound})
    stop = threading.Event()
    # connection hygiene against half-open clients: a per-connection read
    # timeout (a connect-and-vanish client can never pin a reader thread)
    # and a hard concurrent-connection bound (reader threads are the
    # resource being protected — one per connection)
    count_lock = threading.Lock()
    live = [0]

    def _handle(conn):
        try:
            with conn, conn.makefile("r") as rf, conn.makefile("w") as wf:
                conn_lock = threading.Lock()
                try:
                    if _serve_stream(server, rf, wf, conn_lock):
                        stop.set()
                except socket.timeout:
                    # the per-connection read timeout fired: tell a
                    # slow-but-live client why, then free the thread
                    # (a vanished client simply never reads it)
                    try:
                        _out(conn_lock, wf, {
                            "error": "connection idle past "
                            f"{read_timeout_s:.0f}s read timeout",
                            "code": "serve.conn_idle",
                        })
                    except OSError:
                        pass
                except OSError:
                    pass  # client went away mid-read/mid-write
        finally:
            with count_lock:
                live[0] -= 1

    try:
        sock.settimeout(0.5)
        # a set drain flag (SIGTERM/SIGINT) closes the LISTENER first —
        # stop accepting, then main() drains what is already in flight
        while not stop.is_set() and not (
            drain_flag is not None and drain_flag.is_set()
        ):
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            if read_timeout_s and read_timeout_s > 0:
                conn.settimeout(read_timeout_s)
            with count_lock:
                over = live[0] >= max_connections
                if not over:
                    live[0] += 1
            if over:
                # refuse at the door with one classified line — never by
                # silently queueing a connection no thread will read
                try:
                    conn.sendall((json.dumps({
                        "error": "connection limit "
                        f"({max_connections}) reached",
                        "code": "serve.conn_limit",
                    }) + "\n").encode("utf-8"))
                except OSError:
                    pass
                conn.close()
                continue
            threading.Thread(
                target=_handle, args=(conn,), daemon=True
            ).start()
    finally:
        sock.close()


#: seconds the preflight probe may take to reach the card
PREFLIGHT_TIMEOUT_S = 120.0


def _preflight(device: str) -> Optional[str]:
    """Probe the card in a throwaway subprocess (a wedged CUDA driver hangs
    the probe, not the server): None when it answers, else why not."""
    if device != "cuda":
        return None
    import subprocess

    probe = ("import torch; assert torch.cuda.is_available(), 'no CUDA device'; "
             "print(float(torch.ones(8, device='cuda').sum()))")
    try:
        proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                              timeout=PREFLIGHT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return f"the card did not answer the preflight probe within {PREFLIGHT_TIMEOUT_S:.0f}s"
    if proc.returncode != 0 or proc.stdout.strip() != "8.0":
        tail = (proc.stderr.strip().splitlines() or ["no output"])[-1]
        return f"the preflight probe failed (exit {proc.returncode}): {tail}"[:500]
    return None


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    out_lock = threading.Lock()

    if args.preflight:
        failure = _preflight(args.device)
        if failure is not None:
            _out(out_lock, sys.stdout, {"event": "error", "stage": "preflight",
                                        "error": failure})
            return 1

    from spark_gp_tpu_torch.serve.server import GPServeServer

    if not args.model:
        print("at least one --model NAME=PATH is required", file=sys.stderr)
        return 2

    try:
        server = GPServeServer(
            max_batch=args.max_batch,
            min_bucket=args.min_bucket,
            mean_only=args.mean_only,
            capacity=args.capacity,
            max_wait_ms=args.max_wait_ms,
            request_timeout_ms=(
                None if args.request_timeout_ms == 0 else args.request_timeout_ms
            ),
            breaker_threshold=args.breaker_threshold,
            breaker_reset_s=args.breaker_reset_s,
            hang_timeout_s=(
                None if args.hang_timeout_s == 0 else args.hang_timeout_s
            ),
            memory_limit_bytes=args.memory_limit_bytes,
            drain_deadline_s=args.drain_deadline_s,
            replica_id=args.replica_id,
            quality=None if args.quality is None else bool(args.quality),
            device=args.device,
        )
    except (RuntimeError, NotImplementedError) as exc:
        # no GPU without --device cpu, or an unported plane asked for
        _out(out_lock, sys.stdout, {"event": "error", "stage": "start",
                                    "error": f"{type(exc).__name__}: {exc}"[:500]})
        return 1

    # SIGTERM/SIGINT -> graceful drain (serve/lifecycle.py): the handlers
    # only set a flag; the serving loops below watch it.  Installed BEFORE
    # the slow load/warmup so a deploy rollback mid-boot still exits clean.
    from spark_gp_tpu_torch.serve.lifecycle import install_drain_signals

    drain_flag = install_drain_signals()
    for spec in args.model:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            print(f"--model expects NAME=PATH, got {spec!r}", file=sys.stderr)
            return 2
        server.register(name, path)  # loads, and captures every bucket's graph
    server.start()

    chaos_target = os.environ.get("GP_CHAOS_BREAK_MODEL")
    if chaos_target:
        # chaos-harness hook (resilience/chaos.py): make the named model's
        # predict raise so the fault-injection suite can drive the circuit
        # breaker through the REAL CLI process.  Inert unless the env var
        # is set; never set it in production.
        from spark_gp_tpu_torch.resilience.chaos import break_model

        break_model(server, chaos_target, fail_forever=True)

    scrape = None
    if args.metrics_port is not None:
        from spark_gp_tpu_torch.obs.expo import ScrapeListener

        scrape = ScrapeListener(server.openmetrics, port=args.metrics_port)

    _out(out_lock, sys.stdout, {
        "event": "ready",
        "platform": "gpu" if server.device.type == "cuda" else "cpu",
        "device": str(server.device),
        "models": server.registry.describe(),
        "buckets_warmed": sum(
            len(m["compiles"]) for m in server.registry.describe()
        ),
        "metrics_port": None if scrape is None else scrape.port,
    })

    explicit_shutdown = False
    try:
        if args.port is not None:
            _serve_socket(
                server, args.port, out_lock, drain_flag,
                read_timeout_s=args.conn_read_timeout_s,
                max_connections=args.max_connections,
            )
        else:
            # the stdin reader runs on a side thread so a drain signal can
            # act even while the reader is parked in a blocking readline
            # (PEP 475 restarts the read after the flag-only handler runs,
            # so the main thread would never regain control otherwise)
            done = threading.Event()
            result: dict = {}

            def _read_stdin():
                try:
                    result["shutdown"] = _serve_stream(
                        server, sys.stdin, sys.stdout, out_lock
                    )
                finally:
                    done.set()

            threading.Thread(
                target=_read_stdin, name="gp-serve-stdin", daemon=True
            ).start()
            while not done.wait(0.1):
                if drain_flag is not None and drain_flag.is_set():
                    break
            explicit_shutdown = bool(result.get("shutdown"))
    finally:
        if scrape is not None:
            scrape.stop()
        # decided HERE, not in the loop: a signal racing a concurrent
        # stream EOF must still take the drain path (the flag is the
        # truth; only an explicit {"cmd": "shutdown"} outranks it)
        drain_requested = (
            drain_flag is not None
            and drain_flag.is_set()
            and not explicit_shutdown
        )
        if drain_requested:
            # graceful drain: reject new submits (code=queue.shed.draining),
            # complete queued + in-flight work under the deadline, exit 0.
            # A short grace lets the session writer threads flush the final
            # answers before the process-level shutdown line.
            drained = server.drain(args.drain_deadline_s)
            import time as _time

            _time.sleep(0.2)
            _out(out_lock, sys.stdout, {
                "event": "shutdown",
                "drained": drained,
                "requests": server.metrics.counter("requests"),
                "batches": server.metrics.counter("batches"),
            })
            sys.stdout.flush()
            # hard exit AFTER the flushed shutdown line: a daemon thread
            # still inside native code (a canary reload's graph capture
            # the signal interrupted) can abort the process if interpreter
            # finalization tears Python down underneath it; the drained
            # work is done and flushed, so skip finalization
            os._exit(0)
        else:
            server.stop(drain=True)
            if not explicit_shutdown:
                # EOF / socket-mode exit: the session stream never carried a
                # shutdown reply, so emit the process-level event here
                _out(out_lock, sys.stdout, {
                    "event": "shutdown",
                    "requests": server.metrics.counter("requests"),
                    "batches": server.metrics.counter("batches"),
                })
    return 0


if __name__ == "__main__":
    sys.exit(main())
