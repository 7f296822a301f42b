"""Latest-contact-state JSON publisher: the robot's serving endpoint.

Port of ``vision_basedsensor_tpu/io/publish.py``. The contact-plane tilt
drives the 5-axis robot's pose-misalignment compensation (``README.md:124``);
``run-live --publish`` serves the newest per-frame contact state from a
threaded stdlib HTTP server:

  GET /state   -> one JSON object: the latest state (long-polling via
                  ``?seq=N``: blocks until a state newer than N exists)
  GET /events  -> server-sent events; one ``data: <json>`` line per update
  GET /healthz -> 200 "ok" (liveness for orchestrators)

The publisher is a latest-value mailbox (whole-object replacement, so
readers never see a torn state); slow consumers skip states rather than
stall the pipeline.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class StatePublisher:
    """Serve the latest pipeline state as JSON over HTTP.

    ``update(dict)`` is called by the processing loop; consumers poll or
    stream. ``port=0`` binds an ephemeral port (see ``.port``).

    Binds loopback by default: the endpoint has no auth and a permissive
    CORS header, so exposing live contact state to every network peer must
    be an explicit choice (``host="0.0.0.0"``, e.g. on an isolated robot
    LAN — the ``cli run-live --publish-host`` flag), not a default.
    """

    def __init__(self, port: int = 8082, host: str = "127.0.0.1",
                 poll_timeout_s: float = 30.0):
        self._lock = threading.Condition()
        self._state: dict | None = None
        self._seq = 0
        self._running = True
        self._poll_timeout = poll_timeout_s
        publisher = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; the pipeline owns stdout
                pass

            def _send_json(self, payload: bytes, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/healthz":
                    body = b"ok"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/state":
                    try:
                        after = int(parse_qs(u.query).get("seq", ["-1"])[0])
                    except ValueError:
                        self._send_json(b'{"error": "seq must be an '
                                        b'integer"}', 400)
                        return
                    snap = publisher._wait_newer(after)
                    if snap is None and after >= 0:
                        # Long-poll timed out with nothing newer: return the
                        # current state (same seq — the client sees nothing
                        # changed), NOT 404, which means "no state at all".
                        snap = publisher._wait_newer(-1)
                    if snap is None:
                        self._send_json(b'{"error": "no state yet"}', 404)
                    else:
                        self._send_json(json.dumps(snap).encode())
                elif u.path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    # seq starts at 1, so waiting for "newer than 0" blocks
                    # until the first update instead of spinning.
                    last = 0
                    try:
                        while publisher._running:
                            snap = publisher._wait_newer(last)
                            if snap is None:
                                if not publisher._running:
                                    break  # close(): end the stream
                                # Timed out with nothing newer: SSE comment
                                # as keep-alive (clients ignore it; a dead
                                # socket raises here and ends the thread).
                                self.wfile.write(b": keepalive\n\n")
                                self.wfile.flush()
                                continue
                            last = snap["seq"]
                            self.wfile.write(
                                b"data: " + json.dumps(snap).encode()
                                + b"\n\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away — normal
                else:
                    self._send_json(b'{"error": "not found"}', 404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _wait_newer(self, after_seq: int) -> dict | None:
        """Return the newest state strictly newer than ``after_seq``, or
        None on timeout. ``after_seq < 0`` never blocks (plain GET /state:
        latest or None). Condition waits loop until the predicate holds —
        a timed-out or spuriously-woken wait must NOT hand back a state
        the caller already has (that produced duplicate SSE events)."""
        with self._lock:
            if after_seq < 0:
                return None if self._state is None \
                    else dict(self._state, seq=self._seq)
            deadline = time.monotonic() + self._poll_timeout
            while self._state is None or self._seq <= after_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._running:
                    return None
                self._lock.wait(timeout=remaining)
            return dict(self._state, seq=self._seq)

    def update(self, state: dict) -> None:
        """Replace the published state (whole-object swap; never torn)."""
        with self._lock:
            self._seq += 1
            self._state = dict(state)
            self._lock.notify_all()

    def close(self) -> None:
        with self._lock:       # release long-pollers before shutdown
            self._running = False
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


def contact_state_payload(state, frame_index: int,
                          frames_seen: int) -> dict:
    """Flatten one frame of an ``analysis.ContactState`` into a JSON-ready
    dict (the schema a robot-side consumer parses). The frame's eight
    scalars and its validity reach the host in one copy, wherever the
    state lives."""
    import torch
    i = frame_index
    v = torch.stack([state.tilt_deg[i], state.plane.a[i], state.plane.b[i],
                     state.plane.c[i], *state.mean_vector[i],
                     state.mean_magnitude[i],
                     state.valid[i].to(state.tilt_deg.dtype)]).cpu().tolist()
    return {
        "frames_seen": int(frames_seen),
        "tilt_deg": v[0],
        "plane": v[1:4],
        "mean_vector_mm": v[4:7],
        "mean_magnitude_mm": v[7],
        "valid": bool(v[8]),
    }
