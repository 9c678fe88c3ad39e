"""HTTP inference server: stain translation as a service.

Counterpart of ``stain2stain_tpu/server.py``. One fixed-shape tiled
generator (``wsi.make_tiled_generator``) serves every request: images of any
size are tiled and feather-stitched on the host (``wsi.translate_large_image``).
Requests run under a lock, one at a time on the card; stdlib ``http.server``
only.

Endpoints:
    GET  /healthz           -> 200 "ok" (ready: the generator has run once)
    GET  /info              -> JSON {model, tile, overlap, num_steps, ...}
    POST /translate         -> body: PNG/JPEG bytes (or .npy with
                               Content-Type: application/x-npy); response:
                               image/png translated at full input size.

Class conditioning (any2any) is a property of the model (``net.class_cond``):
such a server translates to its default class (``target_class``, 0 if
unset) or to the class a request asks for (``POST
/translate?target_class=K``); a class given to an unconditioned model is
refused (HTTP 400 for a request). Other conditions are fixed for the
server's life and bound into the generator (``**gen_kwargs``, as JAX
``server.py:67, :90-94``): ``mask=`` of the tile batch's shape,
``(batch, tile, tile, 1)``, serves a mask-conditioned task.

Spans (:mod:`.utils.tracing`): any ``torch.profiler`` session that records
while a request begins traces it whole, as a root ``serve.request``
(attribute ``pixels``) over ``serve.read`` (the body), ``serve.decode``
(the image), ``serve.normalize``, ``serve.lock_wait`` (asking for the lock
until holding it), ``serve.locked`` (the tiled translation under the lock,
attribute ``served``: the requests the lock had served before it, and the
``wsi.*`` spans inside), ``serve.denormalize``, ``serve.encode`` (the PNG)
and ``serve.reply``. A direct :meth:`TranslationServer.translate` is a root
of its own. ``tracing.spans()`` returns them after the session; the
session's Chrome trace shows them as CPU events.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .ops.image import denormalize_np, normalize_uint8_np
from .utils import tracing
from .utils.pylogger import RankedLogger
from .wsi import make_conditioned_tiled_generator, make_tiled_generator, translate_large_image

log = RankedLogger(__name__, rank_zero_only=True)

__all__ = ["TranslationServer", "serve_forever"]


class TranslationServer:
    """Holds the tiled generator and translates arbitrary-size images."""

    def __init__(
        self,
        task,
        num_steps: int = 2,
        tile: int = 256,
        overlap: int = 32,
        batch: int = 16,
        target_class: Optional[int] = None,
        **gen_kwargs,
    ):
        self.task = task
        self.num_steps = num_steps
        self.tile = tile
        self.overlap = overlap
        self.batch = batch
        # DoS guards for the long-lived process (tunable attributes): cap the
        # request body and the decoded pixel count BEFORE allocating the
        # float32 working set (4x input + output/weight accumulators).
        self.max_body_bytes = 64 << 20
        self.max_pixels = 1 << 26  # ~67 MP (an 8k x 8k region)
        # conditioning is a property of the model, not of whether a default
        # class was configured: an any2any model served without one still
        # honours per-request classes
        self.conditioned = bool(getattr(task.net, "class_cond", False))
        if target_class is not None and not self.conditioned:
            raise ValueError("target_class given but the model is not class-conditioned")
        self.default_class = (0 if target_class is None else int(target_class)) if self.conditioned else None
        if self.conditioned:
            self._cond_gen = make_conditioned_tiled_generator(task, num_steps=num_steps, **gen_kwargs)
        else:
            self._gen = make_tiled_generator(task, num_steps=num_steps, **gen_kwargs)
        self._lock = threading.Lock()  # one request in flight on the card
        self.requests_served = 0
        self.httpd: Optional[ThreadingHTTPServer] = None
        # Warm on a zero batch (kernel build, cuDNN algorithm choice) so
        # /healthz means "ready to serve".
        warm = np.zeros((batch, tile, tile, 3), np.float32)
        if self.conditioned:
            self._cond_gen(warm, self.default_class)
        else:
            self._gen(warm)

    def translate(self, img_uint8: np.ndarray, target_class: Optional[int] = None) -> np.ndarray:
        """(H, W, 3) uint8 -> (H, W, 3) float32 in [0, 1], any size."""
        if img_uint8.ndim != 3 or img_uint8.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB image, got {img_uint8.shape}")
        if img_uint8.shape[0] * img_uint8.shape[1] > self.max_pixels:
            raise ValueError(
                f"image {img_uint8.shape[0]}x{img_uint8.shape[1]} exceeds the "
                f"{self.max_pixels}-pixel serving cap"
            )
        if target_class is not None and not self.conditioned:
            raise ValueError("this model is not class-conditioned; omit target_class")
        if self.conditioned:
            cls = self.default_class if target_class is None else int(target_class)
            if not 0 <= cls < self.task.net.num_classes:
                raise ValueError(f"target_class {cls} is not in [0, {self.task.net.num_classes})")
            gen = lambda b: self._cond_gen(b, cls)  # noqa: E731
        else:
            gen = self._gen
        with tracing.root("serve.request") as request:
            request.set(pixels=img_uint8.shape[0] * img_uint8.shape[1])
            with tracing.span("serve.normalize"):
                normalized = normalize_uint8_np(img_uint8)
            with tracing.span("serve.lock_wait"):
                self._lock.acquire()
            try:
                with tracing.span("serve.locked", served=self.requests_served):
                    out = translate_large_image(
                        gen, normalized, tile=self.tile, overlap=self.overlap, batch_size=self.batch
                    )
                self.requests_served += 1
            finally:
                self._lock.release()
            with tracing.span("serve.denormalize"):
                return denormalize_np(out)

    @property
    def info(self) -> dict:
        return {
            "model": type(self.task).__name__,
            "num_steps": self.num_steps,
            "tile": self.tile,
            "overlap": self.overlap,
            "batch": self.batch,
            "class_conditioned": self.conditioned,
            "target_class": self.default_class,
            "device": str(self.task.device),
            "requests_served": self.requests_served,
        }


def _decode_request(body: bytes, content_type: str) -> np.ndarray:
    """Decode the request body; every decode failure is a CLIENT error
    (ValueError -> HTTP 400), never a 5xx."""
    try:
        if "npy" in content_type:
            arr = np.load(io.BytesIO(body))
            if arr.dtype != np.uint8:
                # a silent cast would truncate float images to 0/1 garbage
                raise ValueError(f"npy input must be uint8, got {arr.dtype}")
            return arr
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"could not decode request body: {exc}") from exc


def _encode_png(img01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((img01 * 255).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _make_handler(server: TranslationServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log.info(f"{self.address_string()} {fmt % args}")

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            elif self.path == "/info":
                self._reply(200, json.dumps(server.info).encode(), "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            if parsed.path != "/translate":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > server.max_body_bytes:
                    self._reply(413, b"request body too large", "text/plain")
                    return
                query = parse_qs(parsed.query)
                target_class = query.get("target_class")
                target_class = int(target_class[0]) if target_class else None
                with tracing.root("serve.request"):
                    with tracing.span("serve.read"):
                        body = self.rfile.read(length)
                    with tracing.span("serve.decode"):
                        img = _decode_request(body, self.headers.get("Content-Type", ""))
                    out01 = server.translate(img, target_class=target_class)
                    with tracing.span("serve.encode"):
                        png = _encode_png(out01)
                    with tracing.span("serve.reply"):
                        self._reply(200, png, "image/png")
            except ValueError as exc:  # the client's fault: reject, keep serving
                log.warning(f"/translate rejected: {exc}")
                self._reply(400, str(exc).encode(), "text/plain")
            except Exception as exc:  # server-side fault: 5xx so retries/LB react
                log.warning(f"/translate failed: {type(exc).__name__}: {exc}")
                self._reply(500, b"internal error (see server log)", "text/plain")

    return Handler


def serve_forever(
    server: TranslationServer,
    host: str = "0.0.0.0",
    port: int = 8000,
    ready_event: Optional[threading.Event] = None,
) -> None:
    """Run the HTTP loop (blocking). ``ready_event`` fires once bound;
    ``server.httpd.shutdown()`` from another thread ends the loop."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    log.info(f"Serving {server.info['model']} on {host}:{httpd.server_address[1]}")
    server.bound_port = httpd.server_address[1]
    server.httpd = httpd
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
