"""Network-facing live serving: TCP clients drive fleet lanes, PCM streams back
(a copy of zang_tpu/serve/server.py over the port's LiveFleet; the wire
protocol is the JAX package's, byte for byte).

The production deployment of the live tier. The reference's interactive
host is a single-process SDL loop (examples/example.zig:35-83: key events
in, audio-callback out); its network surface is a one-way UDP reload
trigger (watch_script.sh). This server scales that loop out: one
`LiveFleet` (serve/live.py) renders every connected client's session in
one folded device pass a part and block, on the card unless asked for the
CPU (`device`, `--device`), and each client receives its own lane's audio
as a PCM stream over the same TCP connection that carries its events.

Wire protocol (deliberately minimal — newline-delimited JSON control
frames; binary audio payloads):

  client -> server (one JSON object per line):
    {"op": "hello"}                     optional handshake request
    {"op": "event", "part": P, "params": {...},
     "note_id": N?, "impulse_frame": F?}   push_event into this lane
    {"op": "key", "part": P, "key": "q", "down": true, ...}
                                        two-row keyboard map (host/keyboard;
                                        unmapped keys are silently ignored)
    {"op": "stats"}                     serving stats (block cadence vs
                                        realtime budget, lanes, clients)
    {"op": "controller", "part": P, "name": N, "value": V}
                                        continuous-controller move (the
                                        reference's mouseEvent path,
                                        examples/example_mouse.zig) —
                                        fire-and-forget like "event"
    {"op": "params", "part": P}         this part's live-parameter specs +
                                        current values (reference Parameter
                                        panel, examples/common.zig:9-14)
    {"op": "set_param", "part": P, "name": N, "value": V}
    {"op": "step_param", "part": P, "name": N, "delta": D}
                                        change one live parameter; lands on
                                        the next block, no rebuild
                                        (example.zig:324-372 arrow keys)
    {"op": "randomize_params", "part": P, "seed": S?}
                                        Backspace-randomize every parameter
                                        (example.zig:373-391)
    {"op": "record_start"} / {"op": "record_stop"}
                                        server-side per-lane WAV capture
                                        (recorder.zig's feature at the
                                        serving tier; needs record_dir)
    {"op": "resume", "token": T}        continue a dropped session: an
                                        unplanned disconnect retains the
                                        lane's state under the welcome's
                                        resume_token for resume_ttl seconds
    {"op": "snapshot"}                  capture this lane's session state
    {"op": "restore", "nbytes": N}\n + N raw bytes
                                        load a snapshot into this lane —
                                        session migration between servers
                                        (both need allow_migration=True;
                                        blobs are pickle, so only enable on
                                        trusted/internal networks)
    {"op": "bye"}                       orderly detach

  server -> client:
    {"op": "welcome", "lane": L, "sample_rate": SR, "block_size": B,
     "num_channels": C, "dtype": "int16"|"float32",
     "resume_token": T}\n
    {"op": "block", "seq": K, "frame": F, "nbytes": NB}\n  + NB raw bytes
        one [C, B] audio block, C-major, little-endian
    {"op": "record_started", "file": ...} / {"op": "record_stopped",
     "file": ..., "seconds": N}         recording acks (interleaved with
                                        block frames — LiveClient demuxes)
    {"op": "snapshot", "nbytes": NB}\n + NB raw bytes   the session blob
    {"op": "restored", "frame": F}\n    restore ack
    {"op": "error", "message": ...}\n   then the connection closes

Events are fire-and-forget (MIDI discipline): clients that need to
release a note supply their own note_id. Audio is pushed at the fleet's
block cadence; a client that stops reading gets disconnected when its
socket buffer fills and send blocks past send_timeout (a stalled consumer
must not stall the fleet).

The render loop runs in one thread; client reader threads only push
events (LiveSession serializes pushes vs rendering internally) — fleet
attach/detach/render are serialized by the server's lock.
"""

import json
import os
import socket
import socketserver
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..device import require_device
from .live import LiveFleet


class _ClientError(Exception):
    pass


class LiveServer:
    """TCP front-end over a LiveFleet: one lane per connected client.

    make_parts/sample_rate/fleet_kwargs go to the LiveFleet (pcm16_volume
    defaults to 0.5 — network clients want i16 PCM; pass
    pcm16_volume=None to stream f32; device, the card by default). initial_lanes
    pre-sizes the fleet (connections beyond it grow the fleet by doubling —
    prewarm=True renders a block at the next size in the background); max_lanes
    refuses connections beyond a hard cap. realtime=True paces blocks to
    the sample clock; False renders as fast as the device allows (tests,
    faster-than-realtime piping).
    """

    def __init__(
        self,
        make_parts: Callable[[], Sequence],
        sample_rate: float,
        host: str = "127.0.0.1",
        port: int = 0,
        initial_lanes: int = 4,
        max_lanes: int = 256,
        realtime: bool = True,
        send_timeout: float = 2.0,
        pcm16_volume: Optional[float] = 0.5,
        record_dir: Optional[str] = None,
        max_record_blocks: int = 32768,
        allow_migration: bool = False,
        resume_ttl: float = 300.0,
        max_retained: int = 64,
        retain_dir: Optional[str] = None,
        bind: bool = True,
        instrument_name: Optional[str] = None,
        **fleet_kwargs,
    ) -> None:
        self.instrument_name = instrument_name  # set by the multi-instrument
        # front-end; echoed in welcome/stats frames so clients can confirm
        # which fleet they landed on
        self.fleet = LiveFleet(
            make_parts, initial_lanes, sample_rate,
            pcm16_volume=pcm16_volume, **fleet_kwargs)
        self.max_lanes = int(max_lanes)
        self.realtime = bool(realtime)
        self.send_timeout = float(send_timeout)
        self._dtype = "float32" if pcm16_volume is None else "int16"
        self._allow_migration = bool(allow_migration)
        self.resume_ttl = float(resume_ttl)
        self.max_retained = int(max_retained)
        self._retain_dir = retain_dir  # also persist snapshots to disk:
        # resume tokens survive a server RESTART (same instrument spec)
        self._tokens = {}  # lane -> resume token of the connected client
        self._goodbyes = set()  # lanes whose client said bye (don't retain)
        self._retained = {}  # token -> (snapshot blob, expiry monotonic)
        self._record_dir = record_dir
        self._max_record_blocks = int(max_record_blocks)
        self._recordings = {}  # lane -> list of [C, B] blocks
        self._lock = threading.Lock()  # fleet attach/detach/render
        self._clients = {}  # lane -> (socket, per-socket send lock)
        self._seq = 0
        self._block_times = []  # rolling window, seconds
        self._stop = threading.Event()
        self._render_thread: Optional[threading.Thread] = None

        if bind:
            srv = self

            class _Handler(socketserver.BaseRequestHandler):
                def handle(self):  # one thread per client
                    srv._serve_client(self.request)

            self._tcp = socketserver.ThreadingTCPServer(
                (host, port), _Handler, bind_and_activate=True)
            self._tcp.daemon_threads = True
            self.host, self.port = self._tcp.server_address[:2]
        else:
            # backend mode: a front-end (MultiInstrumentServer) owns the
            # socket and hands accepted connections to _serve_client
            self._tcp = None
            self.host = self.port = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start accepting connections and rendering blocks."""
        if self._tcp is not None:
            threading.Thread(
                target=self._tcp.serve_forever, daemon=True).start()
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True)
        self._render_thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
        if self._render_thread is not None:
            self._render_thread.join(timeout=30.0)
        with self._lock:
            if self._retain_dir is not None:
                # drain: persist every connected session so a restarted
                # server (same spec + retain_dir) resumes them by token
                # (readers racing this under _stop persist their own lanes
                # via _detach — both paths are idempotent per lane)
                for lane, tok in list(self._tokens.items()):
                    if lane in self._clients and self._session_has_activity(
                            self.fleet.lanes[lane]):
                        try:
                            blob = self.fleet.snapshot_lane(lane)
                            self._retain_mem(tok, blob)
                            self._retain_disk(tok, blob)
                        except Exception:  # noqa: BLE001 — best-effort
                            pass
            for sock, _slock in list(self._clients.values()):
                try:
                    sock.close()
                except OSError:
                    pass
            self._clients.clear()
        self.fleet.close(timeout=30.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def num_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def stats(self) -> dict:
        """Serving observability: block cadence vs the realtime budget,
        fleet size, client count, blocks served. The block-time window is
        the last 256 blocks; headroom < 1.0 means the fleet is falling
        behind its realtime budget (time to shed lanes or grow chips)."""
        sess = self.fleet.lanes[0]
        budget = sess.block_size / self.fleet._sample_rate
        with self._lock:
            times = list(self._block_times)
            clients = len(self._clients)
            seq = self._seq
        med = float(np.median(times)) if times else None
        return {
            **({"instrument": self.instrument_name}
               if self.instrument_name is not None else {}),
            "clients": clients,
            "lanes": self.fleet.num_lanes,
            "blocks_served": seq,
            "block_budget_ms": round(budget * 1e3, 2),
            "block_time_ms": None if med is None else round(med * 1e3, 2),
            "realtime_headroom": None if med is None
            else round(budget / med, 2),
            "dtype": self._dtype,
        }

    # -- per-client connection --------------------------------------------

    def _attach(self, sock):
        import secrets

        with self._lock:
            if len(self._clients) >= self.max_lanes:
                raise _ClientError(
                    f"server full ({self.max_lanes} lanes)")
            free = [l for l in self.fleet.active_lanes
                    if l not in self._clients]
            # active but unclaimed lanes exist only before first claims;
            # otherwise reuse a detached slot / grow
            if free:
                lane = free[0]
            else:
                lane = self.fleet.attach_lane()
            send_lock = threading.Lock()
            self._clients[lane] = (sock, send_lock)
            self._goodbyes.discard(lane)
            token = secrets.token_hex(16)
            self._tokens[lane] = token
            return lane, send_lock, token

    @staticmethod
    def _session_has_activity(sess) -> bool:
        """True if the lane ever received an event. Probe connections
        (health checks, port scans, protocol errors) never push events;
        retaining their fresh lanes would evict real blipped sessions
        from the bounded store."""
        return any(p.segs[v] or len(p.queue._impulses)
                   for p in sess.parts for v in range(p.polyphony))

    def _detach(self, lane: int, orderly: bool = True,
                expected_sock=None) -> None:
        """Release a lane. expected_sock guards against a deadly reuse
        race: the render loop's targets snapshot can hit a dead socket
        AFTER the lane was detached and re-claimed by a NEW client — a
        blind pop here would kill the new client's lane (it then starves
        until its read timeout). Only the owner may detach."""
        retained = None
        take = None
        with self._lock:
            entry = self._clients.get(lane)
            if entry is None or (expected_sock is not None
                                 and entry[0] is not expected_sock):
                return
            self._clients.pop(lane)
            take = self._recordings.pop(lane, None)
            token = self._tokens.pop(lane, None)
            # "orderly" can be reported by EITHER closer: the reader thread
            # (processed the bye) or the render loop (hit the closing
            # socket first) — the goodbye marker makes them agree. During
            # shutdown (stop set), retention still happens when retain_dir
            # is configured: readers racing close()'s drain must not lose
            # sessions the drain promised to persist.
            orderly = orderly or lane in self._goodbyes
            if (not orderly and token is not None and self.resume_ttl > 0
                    and (not self._stop.is_set()
                         or self._retain_dir is not None)
                    and self._session_has_activity(self.fleet.lanes[lane])):
                # network blip, not a goodbye: retain the session under its
                # resume token so a reconnecting client can continue it
                try:
                    blob = self.fleet.snapshot_lane(lane)
                    self._retain_mem(token, blob)
                    retained = (token, blob)
                except Exception:  # noqa: BLE001 — retention is best-effort
                    pass
            self.fleet.detach_lane(lane)
        if take is not None:
            try:  # a disconnect must not lose an in-progress take
                self._write_take(take)
            except Exception:  # noqa: BLE001 — best-effort flush
                pass
        if retained is not None:
            # disk write OUTSIDE the lock: a slow disk must not stall the
            # render loop (which needs the lock for every fleet block)
            self._retain_disk(*retained)

    def _retain_mem(self, token: str, blob: bytes) -> None:
        """In-memory retention (caller holds the lock); expired entries
        purge lazily, oldest evict beyond the cap."""
        now = time.monotonic()
        self._retained = {
            t: (b, exp) for t, (b, exp) in self._retained.items()
            if exp > now
        }
        while len(self._retained) >= self.max_retained:
            self._retained.pop(next(iter(self._retained)))
        self._retained[token] = (blob, now + self.resume_ttl)

    def _retain_disk(self, token: str, blob: bytes) -> None:
        if self._retain_dir is None:
            return
        try:
            os.makedirs(self._retain_dir, exist_ok=True)
            files = sorted(
                (p for p in os.listdir(self._retain_dir)
                 if p.endswith(".session")),
                key=lambda p: os.path.getmtime(
                    os.path.join(self._retain_dir, p)))
            while len(files) >= self.max_retained:
                os.unlink(os.path.join(self._retain_dir, files.pop(0)))
            with open(os.path.join(self._retain_dir,
                                   f"{token}.session"), "wb") as f:
                f.write(blob)
        except OSError:  # retention is best-effort
            pass

    def _claim_session_file(self, token: str) -> Optional[str]:
        """Atomically claim a token's .session file (rename wins/loses
        cleanly under concurrent resumes). Returns the claimed path."""
        if (self._retain_dir is None or not token
                or any(c not in "0123456789abcdef" for c in token)):
            return None
        path = os.path.join(self._retain_dir, f"{token}.session")
        claimed = f"{path}.claim{threading.get_ident()}"
        try:
            os.rename(path, claimed)
            return claimed
        except OSError:
            return None

    def _take_retained(self, token: str) -> Optional[bytes]:
        """Pop a retained snapshot by token — memory first, then the
        retain_dir (tokens survive server restarts; file age vs
        resume_ttl). Single-use, including under concurrent resumes:
        the memory pop and the file rename are each atomic claims."""
        now = time.monotonic()
        with self._lock:
            entry = self._retained.pop(token, None)
        claimed = self._claim_session_file(token)
        if entry is not None and entry[1] > now:
            if claimed is not None:
                try:
                    os.unlink(claimed)
                except OSError:
                    pass
            return entry[0]
        if claimed is not None:
            try:
                age = time.time() - os.path.getmtime(claimed)
                blob = None
                if age <= self.resume_ttl:
                    with open(claimed, "rb") as f:
                        blob = f.read()
                os.unlink(claimed)
                return blob
            except OSError:
                pass
        return None

    def _serve_client(self, sock, initial_buf: bytes = b"") -> None:
        """Serve one connection. initial_buf carries bytes a front-end
        already read while routing (e.g. the hello line's tail)."""
        sess = self.fleet.lanes[0]  # spec donor for the welcome frame
        sock.settimeout(self.send_timeout)
        lane = None
        orderly = False
        try:
            lane, send_lock, token = self._attach(sock)
            welcome = {
                "op": "welcome", "lane": lane,
                "sample_rate": self.fleet._sample_rate,
                "block_size": sess.block_size,
                "num_channels": sess.num_channels,
                "num_parts": len(sess.parts),
                "dtype": self._dtype,
                "resume_token": token,
            }
            if self.instrument_name is not None:
                welcome["instrument"] = self.instrument_name
            with send_lock:
                _send_json(sock, welcome)
            buf = initial_buf
            first = True  # process any routed-in lines before the first recv
            while not self._stop.is_set():
                if not first or b"\n" not in buf:
                    try:
                        chunk = sock.recv(65536)
                    except socket.timeout:
                        continue
                    if not chunk:
                        return  # disconnect
                    buf += chunk
                first = False
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    msg = json.loads(line)
                    if msg.get("op") == "restore":
                        # bound BEFORE buffering the payload: an oversized/
                        # negative nbytes must not make the server accumulate
                        # an attacker-sized buffer — and the framing past a
                        # lying header can't be trusted, so disconnect
                        need = int(msg["nbytes"])
                        if not 0 <= need <= 64 << 20:
                            raise _ClientError(
                                f"restore nbytes out of range: {need}")
                        if not self._allow_migration:
                            # consume and DISCARD the bounded payload so the
                            # line parser stays in sync, then ack the error
                            # and keep serving this client (nothing is
                            # accumulated: chunks are dropped as they arrive)
                            drop = min(len(buf), need)
                            buf = buf[drop:]
                            remaining = need - drop
                            while remaining > 0:
                                chunk = sock.recv(min(65536, remaining))
                                if not chunk:
                                    return
                                remaining -= len(chunk)
                            self._send_error(
                                sock, lane,
                                "migration disabled (allow_migration)")
                            continue
                        # binary payload follows the header line (it may
                        # contain newlines — consume it before resuming
                        # line-oriented parsing)
                        while len(buf) < need:
                            chunk = sock.recv(65536)
                            if not chunk:
                                return
                            buf += chunk
                        msg["_blob"], buf = buf[:need], buf[need:]
                    try:
                        if self._dispatch(lane, msg):
                            orderly = True
                            return  # bye
                    except _ClientError as e:
                        # recoverable protocol error (bad part index,
                        # unknown param, expired token): ack and keep the
                        # lane alive — a typo'd frame must not tear down a
                        # live audio stream
                        self._send_error(sock, lane, str(e))
        except _ClientError as e:
            self._send_error(sock, lane, str(e))
        except (OSError, ValueError, KeyError, IndexError, TypeError) as e:
            # malformed frame or dead socket: drop the client, keep serving
            self._send_error(sock, lane, repr(e))
        finally:
            if lane is not None:
                self._detach(lane, orderly=orderly, expected_sock=sock)
            try:
                sock.close()
            except OSError:
                pass

    def _send_error(self, sock, lane, message: str) -> None:
        """Best-effort error frame, serialized against block sends when the
        lane is attached (no interleaving mid-payload)."""
        with self._lock:
            entry = self._clients.get(lane) if lane is not None else None
        send_lock = entry[1] if entry else threading.Lock()
        try:
            with send_lock:
                _send_json(sock, {"op": "error", "message": message})
        except OSError:
            pass

    # -- per-lane recording (recorder.zig's feature at the serving tier) ----

    def _record_start(self, lane: int):
        """Returns (fname, seq): blocks with seq > this are in the take
        (registration and the seq read share the render loop's lock)."""
        if self._record_dir is None:
            raise _ClientError("recording disabled (no record_dir)")
        os.makedirs(self._record_dir, exist_ok=True)
        with self._lock:
            if lane in self._recordings:
                raise _ClientError("already recording")
            fname = f"lane{lane}_seq{self._seq + 1}.wav"
            self._recordings[lane] = (fname, [])
            return fname, self._seq

    def _record_stop(self, lane: int):
        """Write the take; returns (fname, seconds) or None if idle."""
        with self._lock:
            entry = self._recordings.pop(lane, None)
        return self._write_take(entry)

    def _write_take(self, entry):
        if entry is None:
            return None
        fname, blocks = entry
        sr = int(self.fleet._sample_rate)
        if blocks:
            audio = np.concatenate(blocks, axis=1)
        else:
            audio = np.zeros((1, 0), np.int16)
        if audio.dtype != np.int16:
            from ..core.mixdown import mixdown_s16_np

            audio = mixdown_s16_np(audio, 1.0)
        from ..core.wav import write_wav_s16

        write_wav_s16(os.path.join(self._record_dir, fname), audio, sr,
                      num_channels=audio.shape[0])
        return fname, audio.shape[1] / float(sr)

    def _part_index(self, lane: int, msg: dict) -> int:
        """Validated part index: a bad index must answer with an error ack,
        not an IndexError that drops the client and detaches its lane."""
        part = int(msg.get("part", 0))
        n = len(self.fleet.lanes[lane].parts)
        if not 0 <= part < n:
            raise _ClientError(
                f"part {part} out of range (instrument has {n} part(s))")
        return part

    def _dispatch(self, lane: int, msg: dict) -> bool:
        """Apply one client frame; True = orderly goodbye."""
        op = msg.get("op")
        if op == "event":
            self.fleet.push_event(
                lane, self._part_index(lane, msg), dict(msg["params"]),
                note_id=msg.get("note_id"),
                impulse_frame=int(msg.get("impulse_frame", 0)))
        elif op == "key":
            kw = {k: v for k, v in msg.items()
                  if k not in ("op", "part", "key", "down")}
            self.fleet.key_event(
                lane, self._part_index(lane, msg), msg["key"],
                bool(msg["down"]), **kw)
        elif op == "controller":
            try:
                self.fleet.push_controller(
                    lane, self._part_index(lane, msg), str(msg["name"]),
                    float(msg["value"]))
            except ValueError as e:
                raise _ClientError(str(e))
        elif op == "params":
            part = self._part_index(lane, msg)
            specs = self.fleet.param_specs(lane, part)
            self._reply(lane, {
                "op": "params", "part": part,
                "specs": [{"name": s.name, "desc": s.desc,
                           "num_values": s.num_values,
                           "favor_low_values": s.favor_low_values,
                           "kind": s.kind} for s in specs],
                "values": self.fleet.get_params(lane, part)})
        elif op in ("set_param", "step_param"):
            part = self._part_index(lane, msg)
            name = str(msg.get("name", ""))
            try:
                if op == "set_param":
                    v = self.fleet.set_param(lane, part, name,
                                             int(msg["value"]))
                else:
                    v = self.fleet.step_param(lane, part, name,
                                              int(msg["delta"]))
            except (KeyError, ValueError) as e:
                raise _ClientError(str(e).strip("'\""))
            self._reply(lane, {"op": "param", "part": part,
                               "name": name, "value": v})
        elif op == "randomize_params":
            part = self._part_index(lane, msg)
            seed = msg.get("seed")
            import random as _random

            rng = _random.Random(seed) if seed is not None else None
            try:
                vals = self.fleet.randomize_params(lane, part, rng=rng)
            except ValueError as e:
                raise _ClientError(str(e))
            self._reply(lane, {"op": "params", "part": part,
                               "values": vals})
        elif op == "stats":
            self._reply(lane, {"op": "stats", **self.stats()})
        elif op == "snapshot":
            if not self._allow_migration:
                raise _ClientError("migration disabled (allow_migration)")
            with self._lock:  # serialize vs the render loop
                blob = self.fleet.snapshot_lane(lane)
            self._reply(lane, {"op": "snapshot", "nbytes": len(blob)},
                        payload=blob)
        elif op == "resume":
            blob = self._take_retained(str(msg.get("token", "")))
            if blob is None:
                raise _ClientError("unknown or expired resume token")
            try:
                with self._lock:
                    self.fleet.restore_lane(lane, blob)
                    frame = self.fleet.lanes[lane].frame
            except Exception as e:  # noqa: BLE001
                raise _ClientError(f"resume failed: {e}")
            self._reply(lane, {"op": "resumed", "frame": frame})
        elif op == "restore":
            if not self._allow_migration:
                raise _ClientError("migration disabled (allow_migration)")
            try:
                with self._lock:
                    self.fleet.restore_lane(lane, msg["_blob"])
                    frame = self.fleet.lanes[lane].frame
            except Exception as e:  # noqa: BLE001 — spec mismatch, corrupt
                # blob (pickle errors are not ValueError): reply, don't drop
                raise _ClientError(f"restore failed: {e}")
            self._reply(lane, {"op": "restored", "frame": frame})
        elif op == "record_start":
            fname, seq = self._record_start(lane)
            # seq lets a client wait until the stream passes the take's
            # start (blocks already in its socket buffer predate the take)
            self._reply(lane, {"op": "record_started", "file": fname,
                               "seq": seq})
        elif op == "record_stop":
            done = self._record_stop(lane)
            if done is None:
                raise _ClientError("not recording")
            self._reply(lane, {"op": "record_stopped", "file": done[0],
                               "seconds": done[1]})
        elif op == "bye":
            with self._lock:
                self._goodbyes.add(lane)
            return True
        elif op == "hello":  # answered by the welcome frame — but a hello
            # naming a DIFFERENT instrument means the router mis-delivered
            # it (e.g. a partial first frame that completed after the
            # hello timeout); refuse rather than silently play the wrong one
            want = msg.get("instrument")
            if (want is not None and self.instrument_name is not None
                    and want != self.instrument_name):
                raise _ClientError(
                    f"this lane serves {self.instrument_name!r}, not "
                    f"{want!r}; reconnect and send the hello frame promptly")
        else:
            raise _ClientError(f"unknown op {op!r}")
        return False

    def _reply(self, lane: int, obj: dict,
               payload: Optional[bytes] = None) -> None:
        with self._lock:
            entry = self._clients.get(lane)
        if entry is None:
            return
        sock, send_lock = entry
        with send_lock:
            _send_json(sock, obj)
            if payload is not None:
                sock.sendall(payload)

    # -- render loop -------------------------------------------------------

    def _render_loop(self) -> None:
        sess = self.fleet.lanes[0]
        block_dt = sess.block_size / self.fleet._sample_rate
        next_deadline = time.monotonic()
        failures = 0  # consecutive render failures
        while not self._stop.is_set():
            with self._lock:
                targets = dict(self._clients)
            if not targets:
                next_deadline = time.monotonic()
                time.sleep(0.01)
                continue
            t0 = time.monotonic()
            try:
                with self._lock:
                    audio = self.fleet.render_block()
                    frame = self.fleet.lanes[0].frame - sess.block_size
            except Exception:  # noqa: BLE001 — the loop must not die silently
                # A dead render thread starves every client until their
                # socket timeouts fire. Ride out transient device errors;
                # on persistent
                # failure close the connections so clients see EOF and can
                # reconnect elsewhere instead of hanging.
                import traceback

                failures += 1
                traceback.print_exc()
                if failures >= 8:
                    print("live server: render loop poisoned — "
                          "closing client connections", flush=True)
                    with self._lock:
                        socks = [s for s, _l in self._clients.values()]
                    for s in socks:
                        try:
                            s.close()
                        except OSError:
                            pass
                    self._stop.set()
                    # also stop ACCEPTING: a live port that welcomes clients
                    # and never streams is worse than a refused connection
                    # (in backend mode the front-end checks _stop and
                    # refuses to route new clients here)
                    if self._tcp is not None:
                        self._tcp.shutdown()
                        self._tcp.server_close()
                    return
                time.sleep(0.05 * failures)
                continue
            failures = 0
            with self._lock:
                self._block_times.append(time.monotonic() - t0)
                if len(self._block_times) > 256:
                    del self._block_times[:-256]
                # seq increments atomically with the take appends so a
                # record_started ack's seq cleanly partitions the stream:
                # blocks with seq > ack seq are in the take, <= are not
                self._seq += 1
                seq = self._seq
                for lane, (_f, blocks) in self._recordings.items():
                    if len(blocks) < self._max_record_blocks:
                        blocks.append(np.array(audio[lane]))
            for lane, (sock, send_lock) in targets.items():
                payload = np.ascontiguousarray(audio[lane]).tobytes()
                try:
                    with send_lock:
                        _send_json(sock, {"op": "block", "seq": seq,
                                          "frame": frame,
                                          "nbytes": len(payload)})
                        sock.sendall(payload)
                except OSError:
                    # stalled/dead consumer: an unplanned drop, so retain
                    # the session for a resume. expected_sock: this lane
                    # may ALREADY belong to a newer client (stale targets
                    # snapshot) — never detach someone else's lane.
                    self._detach(lane, orderly=False, expected_sock=sock)
            if self.realtime:
                next_deadline += block_dt
                delay = next_deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:  # fell behind (e.g. a growth): don't burst
                    next_deadline = time.monotonic()


def _send_json(sock, obj) -> None:
    sock.sendall(json.dumps(obj).encode() + b"\n")


class MultiInstrumentServer:
    """One TCP port serving several instrument specs.

    A LiveFleet folds ONE instrument spec's lanes into one device pass
    (all lanes run the same step), so heterogeneous serving means one fleet per
    spec. This front-end owns the socket; each named instrument gets its
    own backend LiveServer (fleet + render loop, no TCP bind of its own),
    created lazily on the first connection that asks for it so unused
    specs never hold device memory. The client's FIRST frame picks the fleet:

        {"op": "hello", "instrument": "nice"}

    A first frame of {"op": "instruments"} gets the menu back (available
    names + default) and the connection closes — discovery without
    allocating a lane. A first frame that is any other op (or a hello
    without "instrument") routes to `default_instrument` and is then
    processed normally by the backend; a client that sends nothing routes
    to the default after `hello_timeout` seconds. After routing, the connection speaks the
    plain LiveServer protocol (welcome/blocks/events/resume/...) against
    its backend — resume tokens are per-backend, so reconnecting clients
    must hello the same instrument before resuming.

    `instruments` maps name -> dict of LiveServer kwargs (make_parts and
    sample_rate required; anything else optional), merged over
    `common_kwargs`. A shared `retain_dir` is split into one subdirectory
    per instrument (snapshots are only restorable onto the same spec).

    The reference analog: its 19 example programs are 19 different
    instruments a user picks at launch (build.zig run steps); here one
    serving endpoint hosts them all concurrently.
    """

    def __init__(
        self,
        instruments,
        host: str = "127.0.0.1",
        port: int = 0,
        default_instrument: Optional[str] = None,
        hello_timeout: float = 3.0,
        retain_dir: Optional[str] = None,
        **common_kwargs,
    ) -> None:
        if not instruments:
            raise ValueError("instruments must be a non-empty mapping")
        self._specs = {str(k): dict(v) for k, v in instruments.items()}
        for name, spec in self._specs.items():
            for req in ("make_parts", "sample_rate"):
                if req not in spec:
                    raise ValueError(
                        f"instrument {name!r} spec is missing {req!r}")
        self.default_instrument = (
            default_instrument if default_instrument is not None
            else next(iter(self._specs)))
        if self.default_instrument not in self._specs:
            raise ValueError(
                f"default_instrument {self.default_instrument!r} is not in "
                f"instruments {sorted(self._specs)}")
        self.hello_timeout = float(hello_timeout)
        self._retain_dir = retain_dir
        self._common = dict(common_kwargs)
        # the fleets are made on first use: refuse a device this process
        # lacks now, not at a client's hello
        require_device(self._common.get("device", "cuda"))
        self._backends = {}  # name -> started LiveServer (bind=False)
        self._creating = {}  # name -> Event (per-name creation in flight)
        self._lock = threading.Lock()
        self._stop = threading.Event()

        srv = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one thread per client
                srv._route(self.request)

        self._tcp = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._tcp.daemon_threads = True
        self.host, self.port = self._tcp.server_address[:2]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        threading.Thread(target=self._tcp.serve_forever, daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        self._tcp.shutdown()
        self._tcp.server_close()
        with self._lock:
            backends = list(self._backends.values())
        for b in backends:
            b.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def instrument_names(self):
        return sorted(self._specs)

    def backend(self, name: str) -> LiveServer:
        """The backend LiveServer for `name`, creating (and starting) it
        on first use. Creation is serialized PER NAME (a cold instrument's
        construction must not stall routing/stats for warm ones — the
        global lock only guards the dicts); the fleet's first block (and
        its kernels' build) happens on its render thread, off this path."""
        while True:
            with self._lock:
                b = self._backends.get(name)
                if b is not None:
                    return b
                if self._stop.is_set():
                    raise _ClientError("server closing")
                ev = self._creating.get(name)
                if ev is None:
                    ev = self._creating[name] = threading.Event()
                    break  # this thread creates
            ev.wait(timeout=120.0)  # another thread is creating; re-check
        try:
            spec = dict(self._common)
            spec.update(self._specs[name])
            if self._retain_dir is not None and "retain_dir" not in spec:
                spec["retain_dir"] = os.path.join(self._retain_dir, name)
            make_parts = spec.pop("make_parts")
            sample_rate = spec.pop("sample_rate")
            b = LiveServer(make_parts, sample_rate, bind=False,
                           instrument_name=name, **spec)
            b.start()
            with self._lock:
                if self._stop.is_set():
                    # close() snapshotted _backends without this one; shut
                    # it down here so no render thread is orphaned
                    should_close = True
                else:
                    self._backends[name] = b
                    should_close = False
            if should_close:
                b.close()
                raise _ClientError("server closing")
            return b
        finally:
            with self._lock:
                self._creating.pop(name).set()

    def stats(self) -> dict:
        """Aggregate + per-instrument serving stats (only instantiated
        backends appear; connect-and-ask gives per-fleet detail)."""
        with self._lock:
            backends = dict(self._backends)
        per = {name: b.stats() for name, b in backends.items()}
        return {
            "instruments": per,
            "available": self.instrument_names,
            "clients": sum(p["clients"] for p in per.values()),
        }

    @property
    def num_clients(self) -> int:
        with self._lock:
            backends = list(self._backends.values())
        return sum(b.num_clients for b in backends)

    # -- routing ------------------------------------------------------------

    def _route(self, sock) -> None:
        """Read the first frame (bounded), pick the backend, hand over."""
        sock.settimeout(self.hello_timeout)
        buf = b""
        try:
            while b"\n" not in buf:
                if len(buf) > 65536:
                    raise _ClientError("first frame too large")
                try:
                    chunk = sock.recv(65536)
                except socket.timeout:
                    if buf:
                        # a PARTIAL first frame is a stalled/malformed
                        # client, not a silent one — routing it to the
                        # default instrument would silently ignore the
                        # instrument field when the line completes later
                        raise _ClientError(
                            "first frame incomplete within hello timeout")
                    break  # silent client: default instrument
                if not chunk:
                    return  # connected and left
                buf += chunk
            name = self.default_instrument
            if b"\n" in buf:
                line, rest = buf.split(b"\n", 1)
                try:
                    msg = json.loads(line) if line.strip() else {}
                except ValueError:
                    raise _ClientError("malformed first frame")
                if msg.get("op") == "instruments":
                    # menu discovery: reply and close, no lane allocated
                    _send_json(sock, {
                        "op": "instruments",
                        "available": self.instrument_names,
                        "default": self.default_instrument,
                    })
                    return
                if msg.get("op") == "hello":
                    want = msg.get("instrument")
                    if want is not None:
                        if want not in self._specs:
                            raise _ClientError(
                                f"unknown instrument {want!r}; available: "
                                f"{self.instrument_names}")
                        name = str(want)
                    buf = rest  # hello consumed
                # any other op: default instrument, frame left in buf for
                # the backend to process
            if self._stop.is_set():
                return
            try:
                backend = self.backend(name)
            except _ClientError:
                raise
            except Exception as e:  # fleet construction failed (bad spec):
                # tell the client instead of a silent hang-until-timeout
                raise _ClientError(
                    f"instrument {name!r} failed to start: {e!r}") from e
            if backend._stop.is_set():
                raise _ClientError(f"instrument {name!r} is unavailable")
        except _ClientError as e:
            try:
                _send_json(sock, {"op": "error", "message": str(e)})
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            return
        except OSError:
            try:
                sock.close()
            except OSError:
                pass
            return
        backend._serve_client(sock, initial_buf=buf)


def list_instruments(host: str, port: int, timeout: float = 10.0) -> dict:
    """Ask a serving endpoint for its instrument menu. Against a
    MultiInstrumentServer returns {"op": "instruments", "available":
    [...], "default": ...}; against a plain LiveServer the reply is its
    welcome frame (op == "welcome": single-instrument endpoint)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        _send_json(sock, {"op": "instruments"})
        buf = b""
        while b"\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise EOFError("server closed before replying")
            buf += chunk
        return json.loads(buf.split(b"\n", 1)[0])
    finally:
        sock.close()


# -- a minimal client, for tests and piping ---------------------------------


class LiveClient:
    """Blocking client for LiveServer's protocol (tests, CLI piping).

    Always leads with a hello frame: a plain LiveServer treats it as a
    no-op, a MultiInstrumentServer routes on it (pass `instrument` to
    pick a fleet; None lands on the server's default instrument)."""

    def __init__(self, host: str, port: int, timeout: float = 300.0,
                 instrument: Optional[str] = None) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.instrument = instrument
        self._buf = b""
        self._pending_blocks = []
        self._pending_ctrl = []
        self.last_block_seq = 0  # seq of the newest block frame received
        self.last_block_frame = None  # its "frame" (the fleet's clock)
        hello = {"op": "hello"}
        if instrument is not None:
            hello["instrument"] = instrument
        _send_json(self.sock, hello)
        self.welcome = self._read_json()
        if self.welcome.get("op") == "error":
            raise RuntimeError(self.welcome["message"])
        assert self.welcome["op"] == "welcome", self.welcome

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("server closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_json(self) -> dict:
        while b"\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("server closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def send_event(self, part: int, params: dict, note_id=None,
                   impulse_frame: int = 0) -> None:
        msg = {"op": "event", "part": part, "params": params,
               "impulse_frame": impulse_frame}
        if note_id is not None:
            msg["note_id"] = note_id
        _send_json(self.sock, msg)

    def send_key(self, part: int, key: str, down: bool, **kw) -> None:
        _send_json(self.sock, {"op": "key", "part": part, "key": key,
                               "down": down, **kw})

    def send_controller(self, part: int, name: str, value: float) -> None:
        """Continuous-controller move (mouse path); fire-and-forget."""
        _send_json(self.sock, {"op": "controller", "part": part,
                               "name": name, "value": value})

    def _next_frame(self):
        """(kind, value): ("block", array) or (op, header dict)."""
        hdr = self._read_json()
        op = hdr.get("op")
        if op == "error":
            raise RuntimeError(hdr["message"])
        if op == "snapshot":  # header + binary blob
            hdr["blob"] = self._read_exact(hdr["nbytes"])
            return op, hdr
        if op != "block":
            return op, hdr
        raw = self._read_exact(hdr["nbytes"])
        self.last_block_seq = hdr.get("seq", self.last_block_seq)
        self.last_block_frame = hdr.get("frame", self.last_block_frame)
        dtype = np.dtype(self.welcome["dtype"]).newbyteorder("<")
        a = np.frombuffer(raw, dtype=dtype)
        return "block", a.reshape(self.welcome["num_channels"],
                                  self.welcome["block_size"])

    def read_block(self) -> np.ndarray:
        """Next audio block as [num_channels, block_size] (control frames
        arriving first are queued for read_control)."""
        if self._pending_blocks:
            return self._pending_blocks.pop(0)
        while True:
            kind, v = self._next_frame()
            if kind == "block":
                return v
            self._pending_ctrl.append(v)

    def read_control(self) -> dict:
        """Next non-block frame (record acks...); audio arriving first is
        queued for read_block."""
        if self._pending_ctrl:
            return self._pending_ctrl.pop(0)
        while True:
            kind, v = self._next_frame()
            if kind != "block":
                return v
            self._pending_blocks.append(v)

    def record_start(self) -> dict:
        """Start a server-side take of this lane; returns the ack
        ({"file": ..., "seq": ...} — blocks with seq > this are in the
        take; already-buffered blocks with seq <= it predate it)."""
        _send_json(self.sock, {"op": "record_start"})
        ack = self.read_control()
        assert ack["op"] == "record_started", ack
        return ack

    def record_stop(self) -> dict:
        """Finish the take; returns {"file": ..., "seconds": ...}."""
        _send_json(self.sock, {"op": "record_stop"})
        ack = self.read_control()
        assert ack["op"] == "record_stopped", ack
        return ack

    def stats(self) -> dict:
        _send_json(self.sock, {"op": "stats"})
        ack = self.read_control()
        assert ack["op"] == "stats", ack
        return ack

    def params(self, part: int = 0) -> dict:
        """Live-parameter specs + current values for one part."""
        _send_json(self.sock, {"op": "params", "part": part})
        ack = self.read_control()
        assert ack["op"] == "params", ack
        return ack

    def set_param(self, part: int, name: str, value: int) -> int:
        _send_json(self.sock, {"op": "set_param", "part": part,
                               "name": name, "value": value})
        ack = self.read_control()
        assert ack["op"] == "param", ack
        return ack["value"]

    def step_param(self, part: int, name: str, delta: int) -> int:
        _send_json(self.sock, {"op": "step_param", "part": part,
                               "name": name, "delta": delta})
        ack = self.read_control()
        assert ack["op"] == "param", ack
        return ack["value"]

    def randomize_params(self, part: int = 0, seed=None) -> dict:
        msg = {"op": "randomize_params", "part": part}
        if seed is not None:
            msg["seed"] = seed
        _send_json(self.sock, msg)
        ack = self.read_control()
        assert ack["op"] == "params", ack
        return ack["values"]

    def resume(self, token: str) -> int:
        """Continue a session dropped by a network blip: the server
        retained the lane's state under the welcome frame's resume_token
        for resume_ttl seconds. Returns the restored frame."""
        _send_json(self.sock, {"op": "resume", "token": token})
        ack = self.read_control()
        assert ack["op"] == "resumed", ack
        return ack["frame"]

    def snapshot(self) -> bytes:
        """Capture this lane's full session state (server must allow
        migration); restore it on any server with the same instrument
        spec to continue the session there."""
        _send_json(self.sock, {"op": "snapshot"})
        ack = self.read_control()
        assert ack["op"] == "snapshot", ack
        return ack["blob"]

    def restore(self, blob: bytes) -> int:
        """Load a snapshot into this lane; returns the restored frame."""
        _send_json(self.sock, {"op": "restore", "nbytes": len(blob)})
        self.sock.sendall(blob)
        ack = self.read_control()
        assert ack["op"] == "restored", ack
        return ack["frame"]

    def close(self) -> None:
        try:
            _send_json(self.sock, {"op": "bye"})
        except OSError:
            pass
        self.sock.close()


def builtin_instruments(sample_rate: float, polyphony: int):
    """The stock serving menu: the reference's reusable example
    instruments (examples/modules.zig) as multi-server specs."""
    from ..host import instruments as ti

    def spec(mk):
        return {"make_parts": mk, "sample_rate": sample_rate}

    return {
        "nice": spec(lambda: [(ti.NiceInstrument(0.3), polyphony)]),
        "pmosc": spec(lambda: [(ti.PMOscInstrument(1.0), polyphony)]),
        "hardsquare": spec(lambda: [(ti.HardSquareInstrument(), polyphony)]),
        "filteredsaw": spec(
            lambda: [(ti.FilteredSawtoothInstrument(), polyphony)]),
        "weirdsquare": spec(
            lambda: [(ti.SquareWithEnvelope(weird=True), polyphony)]),
    }


def _script_spec(path: str, sample_rate: float, polyphony: int):
    """A zangscript file as a serving spec: compile once up front (a bad
    script should fail at server start, not at a client's first hello).
    `path` may be FILE or FILE:MODULE; default is the last exported
    module (the reference's convention — the player module is the last
    global, e.g. DemoPlayer in examples/script.txt)."""
    from ..script.compile import compile_script
    from ..script.torch_backend import ScriptInstrument

    module = None
    if not os.path.exists(path) and ":" in path:
        path, _, module = path.rpartition(":")
    with open(path) as f:
        src = f.read()
    cs = compile_script(src, filename=path)
    if not cs.exported_modules:
        raise ValueError(f"{path}: script exports no modules")
    names = [em.name for em in cs.exported_modules]
    if module is None:
        module = names[-1]
    elif module not in names:
        raise ValueError(f"{path}: no exported module {module!r} "
                         f"(available: {names})")

    return {
        "make_parts": lambda: [(ScriptInstrument(cs, module), polyphony)],
        "sample_rate": sample_rate,
    }


def _main(argv=None):  # serve the stock instruments (and any --script) on a TCP port
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve live synth sessions over TCP (PCM16 blocks out, "
                    "JSON events in — see module docstring for the "
                    "protocol). Each instrument gets its own fleet, "
                    "created on first use; clients pick one with "
                    "zang-play --instrument NAME.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9800)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--sample-rate", type=float, default=48000.0)
    ap.add_argument("--lanes", type=int, default=4,
                    help="initial lanes per instrument fleet (grows on "
                         "demand)")
    ap.add_argument("--max-lanes", type=int, default=256,
                    help="hard cap per instrument fleet")
    ap.add_argument("--polyphony", type=int, default=4)
    ap.add_argument("--instrument", default="nice",
                    help="default instrument for clients that don't pick")
    ap.add_argument("--script", action="append", default=[],
                    metavar="NAME=FILE[:MODULE]",
                    help="also serve a zangscript instrument (repeatable; "
                         "MODULE defaults to the script's last export)")
    ap.add_argument("--list", action="store_true",
                    help="print the instrument menu and exit")
    ap.add_argument("--retain-dir",
                    help="persist blipped sessions here so resume tokens "
                         "survive server restarts")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seconds", type=float, default=None,
                    help="serve this long, then close (default: until ^C)")
    args = ap.parse_args(argv)

    menu = builtin_instruments(args.sample_rate, args.polyphony)
    for item in args.script:
        name, _, path = item.partition("=")
        if not path:
            raise SystemExit(f"--script wants NAME=FILE, got {item!r}")
        menu[name] = _script_spec(path, args.sample_rate, args.polyphony)
    if args.list:
        for name in sorted(menu):
            print(name)
        return
    if args.instrument not in menu:
        raise SystemExit(
            f"unknown default instrument {args.instrument!r}; "
            f"available: {sorted(menu)}")

    srv = MultiInstrumentServer(
        menu, host=args.host, port=args.port,
        default_instrument=args.instrument,
        retain_dir=args.retain_dir,
        initial_lanes=args.lanes, max_lanes=args.max_lanes,
        block_size=args.block_size, prewarm=True, device=args.device)
    srv.start()
    print(f"live server on {srv.host}:{srv.port} "
          f"(block {args.block_size} @ {args.sample_rate:.0f} Hz on {args.device}; "
          f"instruments: {', '.join(sorted(menu))}; "
          f"default {args.instrument})", flush=True)
    try:
        end = None if args.seconds is None else time.monotonic() + args.seconds
        while end is None or time.monotonic() < end:
            time.sleep(0.2 if end is not None else 3600)
    except KeyboardInterrupt:
        pass
    srv.close()


if __name__ == "__main__":
    _main()
