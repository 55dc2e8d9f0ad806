"""Asyncio HTTP/1.1 + SSE front door over the serving frontend.

A copy of `mdi_llm_tpu/server/http.py` over the port's frontend.  Stdlib
only: `asyncio.start_server` streams, a ~hundred-line HTTP/1.1 request
parser, and Server-Sent Events for token streaming.  The HTTP layer holds NO
model state: every request flows through `ServingFrontend.submit` and
its token events arrive via a `loop.call_soon_threadsafe` bridge from
the engine thread, so the asyncio loop never blocks on device work and
the engine thread never touches a socket.

API:

- ``POST /v1/completions`` — body ``{"prompt": [ids] | "text",
  "max_tokens": N, "stream": bool, "priority", "tenant",
  "ttft_slo_ms", "stop": [[ids], ...]}``.  ``stream: true`` answers
  ``text/event-stream``: one ``token`` event per generated token, a
  final ``done`` event with the request summary (or ``error``); client
  disconnect mid-stream cancels the request at the next step boundary.
  Non-streaming answers one JSON body on completion.
- backpressure: 429 + ``Retry-After`` when the admission queue is at
  its bound; 503 while draining; 400 for infeasible/invalid requests.
- ``GET /healthz`` — liveness + queue/lane depths (200 serving, 503
  draining).
- ``GET /v1/stats`` — the canonical `ServingStats.to_dict()` plus
  latency percentiles.
- ``GET /metrics`` — Prometheus text exposition of the observer's
  registry.

Graceful drain (`shutdown()`): stop accepting (new requests see 503),
wait for in-flight requests up to `drain_timeout_s`, stop the engine
thread, close the listener.
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

from mdi_llm_tpu_torch.server.frontend import (
    FrontendClosedError,
    QueueFullError,
    ServingFrontend,
)

__all__ = ["ServingHTTPServer"]

_MAX_HEADER_BYTES = 65536
_MAX_BODY_BYTES = 16 * 1024 * 1024

_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _response_head(status: int, content_type: str,
                   extra: Optional[Dict[str, str]] = None,
                   content_length: Optional[int] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}",
             f"Content-Type: {content_type}",
             "Connection: close"]
    if content_length is not None:
        lines.append(f"Content-Length: {content_length}")
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _sse(event: str, data: Dict) -> bytes:
    return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()


class ServingHTTPServer:
    """One HTTP listener over one `ServingFrontend`.

    `tokenizer` (optional) enables text prompts and decoded text in
    responses; token-id prompts always work.  `start()` binds and
    starts the engine thread if the frontend has not been started;
    `serve_forever()` blocks until `shutdown()` (e.g. from a signal
    handler).  Port 0 binds an ephemeral port (tests); `self.port`
    reports the bound one.
    """

    def __init__(self, frontend: ServingFrontend, host: str = "127.0.0.1",
                 port: int = 8000, tokenizer=None,
                 drain_timeout_s: float = 30.0):
        self.frontend = frontend
        self.host = host
        self.port = port
        self.tokenizer = tokenizer
        self.drain_timeout_s = drain_timeout_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown = asyncio.Event()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        if self.frontend._thread is None:
            self.frontend.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        await self._shutdown.wait()

    async def shutdown(self) -> None:
        """Graceful drain: refuse new work (503), wait for in-flight
        requests, stop the engine thread, close the listener."""
        # drain() flips the frontend closed; run the blocking wait off
        # the event loop so open SSE streams keep flushing through it
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.frontend.drain(timeout=self.drain_timeout_s)
        )
        await asyncio.get_running_loop().run_in_executor(
            None, self.frontend.stop
        )
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._shutdown.set()

    # -- request plumbing ----------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, headers = await self._read_head(reader)
                body = await self._read_body(reader, headers)
            except _HTTPError as e:
                await self._send_json(writer, e.status,
                                      {"error": e.message})
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            try:
                await self._route(method, path, body, writer)
            except _HTTPError as e:
                await self._send_json(
                    writer, e.status, {"error": e.message},
                    extra={"Retry-After": "1"} if e.status == 429 else None,
                )
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception as e:  # one bad request must not kill the server
                await self._send_json(
                    writer, 500, {"error": f"{type(e).__name__}: {e}"}
                )
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_head(self, reader) -> Tuple[str, str, Dict[str, str]]:
        head = await reader.readuntil(b"\r\n\r\n")
        if len(head) > _MAX_HEADER_BYTES:
            raise _HTTPError(413, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise _HTTPError(400, f"malformed request line: {lines[0]!r}")
        method, path, _version = parts
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        return method.upper(), path, headers

    async def _read_body(self, reader, headers: Dict[str, str]) -> bytes:
        n = int(headers.get("content-length", "0") or "0")
        if n > _MAX_BODY_BYTES:
            raise _HTTPError(413, f"body of {n} bytes exceeds the "
                             f"{_MAX_BODY_BYTES} limit")
        return await reader.readexactly(n) if n else b""

    async def _send_json(self, writer, status: int, payload: Dict,
                         extra: Optional[Dict[str, str]] = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        writer.write(_response_head(status, "application/json",
                                    extra=extra, content_length=len(body)))
        writer.write(body)
        await writer.drain()

    # -- routes --------------------------------------------------------------

    async def _route(self, method: str, path: str, body: bytes,
                     writer) -> None:
        path = path.split("?", 1)[0]
        if path == "/healthz" and method == "GET":
            await self._healthz(writer)
        elif path == "/v1/stats" and method == "GET":
            await self._stats(writer)
        elif path == "/metrics" and method == "GET":
            await self._metrics(writer)
        elif path == "/v1/completions":
            if method != "POST":
                raise _HTTPError(405, "POST only")
            await self._completions(body, writer)
        else:
            raise _HTTPError(404, f"no route for {method} {path}")

    async def _healthz(self, writer) -> None:
        eng = self.frontend.engine
        draining = self.frontend._draining
        await self._send_json(writer, 503 if draining else 200, {
            "status": "draining" if draining else "ok",
            "queue_depth": self.frontend.queue_depth(),
            "queue_bound": self.frontend.max_queue,
            "live_lanes": len(eng.scheduler.running()),
            "max_batch": eng.scheduler.max_batch,
            "requests_finished": eng.stats.requests_finished,
            "requests_rejected": eng.stats.requests_rejected,
        })

    async def _stats(self, writer) -> None:
        eng = self.frontend.engine
        out = eng.stats.to_dict()
        if eng.obs is not None:
            out["latency"] = eng.obs.latency_summaries()
        await self._send_json(writer, 200, out)

    async def _metrics(self, writer) -> None:
        obs = self.frontend.engine.obs
        if obs is None:
            raise _HTTPError(404, "no observer attached (metrics disabled)")
        body = obs.metrics.render_prometheus().encode()
        writer.write(_response_head(
            200, "text/plain; version=0.0.4", content_length=len(body)
        ))
        writer.write(body)
        await writer.drain()

    # -- completions ---------------------------------------------------------

    def _parse_completion(self, body: bytes) -> Dict:
        try:
            req = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _HTTPError(400, f"invalid JSON body: {e}")
        if not isinstance(req, dict):
            raise _HTTPError(400, "body must be a JSON object")
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise _HTTPError(
                    400, "text prompts need a server-side tokenizer "
                    "(start cli.server with --ckpt); send token ids"
                )
            prompt = [int(t) for t in self.tokenizer.encode(prompt)]
        elif isinstance(prompt, list) and all(
            isinstance(t, int) for t in prompt
        ):
            prompt = list(prompt)
        else:
            raise _HTTPError(
                400, "prompt must be a string or a list of token ids"
            )
        try:
            max_tokens = int(req.get("max_tokens", 64))
        except (TypeError, ValueError):
            raise _HTTPError(400, "max_tokens must be an integer")
        stop = req.get("stop", ())
        if stop and not (
            isinstance(stop, list)
            and all(isinstance(s, list)
                    and all(isinstance(t, int) for t in s) for s in stop)
        ):
            raise _HTTPError(400, "stop must be a list of token-id lists")
        ttft_ms = req.get("ttft_slo_ms")
        return {
            "prompt": prompt,
            "max_new_tokens": max_tokens,
            "stop_sequences": tuple(tuple(s) for s in stop) if stop else (),
            "priority": int(req.get("priority", 0)),
            "tenant": str(req.get("tenant", "")),
            "ttft_slo_s": float(ttft_ms) / 1e3 if ttft_ms is not None else None,
            "stream": bool(req.get("stream", False)),
        }

    def _submit(self, kwargs: Dict, sink=None):
        stream = kwargs.pop("stream")
        try:
            handle = self.frontend.submit(sink=sink, **kwargs)
        except QueueFullError as e:
            raise _HTTPError(429, str(e))
        except FrontendClosedError as e:
            raise _HTTPError(503, str(e))
        except ValueError as e:
            raise _HTTPError(400, str(e))
        return handle, stream

    def _decode(self, tokens) -> Optional[str]:
        if self.tokenizer is None or not tokens:
            return None
        try:
            import numpy as np

            return self.tokenizer.decode(np.asarray(list(tokens)))
        except Exception:
            return None

    def _summary(self, handle) -> Dict:
        gen = handle.generated()
        out = {
            "rid": handle.rid,
            "n_prompt": handle.n_prompt,
            "n_generated": len(gen),
            "tokens": [int(t) for t in gen],
        }
        text = self._decode(gen)
        if text is not None:
            out["text"] = text
        return out

    async def _completions(self, body: bytes, writer) -> None:
        kwargs = self._parse_completion(body)
        if not kwargs["stream"]:
            handle, _ = self._submit(kwargs)
            # completion latch is a threading.Event set on the engine
            # thread; wait off-loop so slow generations never stall
            # other connections
            await asyncio.get_running_loop().run_in_executor(
                None, handle.done.wait
            )
            if handle.error is not None:
                raise _HTTPError(500, handle.error)
            await self._send_json(writer, 200, self._summary(handle))
            return

        # SSE streaming: engine-thread events bridge into this
        # connection's asyncio queue via call_soon_threadsafe — the one
        # thread-crossing point, append-only and non-blocking on the
        # engine side
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def sink(event):  # mdi-thread: engine
            loop.call_soon_threadsafe(q.put_nowait, event)

        handle, _ = self._submit(kwargs, sink=sink)
        writer.write(_response_head(
            200, "text/event-stream", extra={"Cache-Control": "no-cache"}
        ))
        try:
            await writer.drain()
            while True:
                kind, payload = await q.get()
                if kind == "token":
                    ev: Dict = {"token": int(payload)}
                    piece = self._decode([payload])
                    if piece is not None:
                        ev["text"] = piece
                    writer.write(_sse("token", ev))
                elif kind == "done":
                    writer.write(_sse("done", self._summary(handle)))
                    await writer.drain()
                    return
                elif kind == "cancelled":
                    writer.write(_sse("done", dict(
                        self._summary(handle), cancelled=True
                    )))
                    await writer.drain()
                    return
                else:  # error
                    writer.write(_sse("error", {"error": str(payload)}))
                    await writer.drain()
                    return
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            # client went away mid-stream: release the lane — the engine
            # retires the request at its next step boundary
            self.frontend.cancel(handle.rid)
            raise
