"""Persistent single-image -> mesh service on the card (the port's ``serve.py``).

    python -m slice3d_tpu_torch.serve --name_model slicenet --name_exp exp1 \\
        --name_ckpt m.ckpt --mc_res0 64 --mc_up_steps 2 --port 8080 \\
        [--mc_batch_size 4 --batch_window_ms 80] [--device cpu]
    python -m slice3d_tpu_torch.serve --name_model disn --random_init \\
        [--mc_refine_steps 30 --simplify_nfaces 20000 --mc_extract tetrahedra]

Builds the model and the ``Reconstructor`` once, warms them up (the first
padded batch builds the kernels and the mesh library), then answers requests
over HTTP.  The same endpoints as the JAX package's root ``serve.py``:

  GET  /healthz            -> {"ok": true, model / operating point / serving stats}
  POST /reconstruct        -> OBJ text (body: a PNG, or another format when
                              Pillow is installed; RGBA alpha marks the
                              object).  Query params:
                                center=1     alpha-bbox recenter (default 1)
                                format=json  -> {"obj": ..., "stats": ...}
                              Per-request stats ride the X-Slice3D-Stats
                              header either way.  400 on a bad image.

Device access is serialized with a lock (one card, one model); the HTTP
layer is threaded, so decoding overlaps device work.  With
``--mc_batch_size B`` (B > 1) requests arriving within ``--batch_window_ms``
of the first share one padded ``reconstruct_batch`` call.  ``--device``
(default ``cuda``) is the one flag the JAX service does not have.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import camera
from .config import Options, options_from_args
from .data.dataset import preprocess_image
from .data.image import center_rgba, decode_image
from .mesh import Mesh, obj_string

__all__ = ["Slice3DService", "build_service", "make_handler", "main"]


class _PendingRequest:
    __slots__ = ("feed", "event", "result", "error")

    def __init__(self, feed):
        self.feed = feed
        self.event = threading.Event()
        self.result = None
        self.error = None


class Slice3DService:
    """Model and ``Reconstructor`` resident on the device; thread-safe
    ``reconstruct``.

    With ``recon.batch_size > 1`` requests are micro-batched: the first one
    opens a window of ``batch_window_ms``, the requests that arrive within it
    (up to the batch size) ride the same ``reconstruct_batch`` call, padded
    to the batch size with copies of its last feed.  ``close`` stops the
    batching thread.
    """

    def __init__(self, opts: Options, recon, batch_window_ms: float = 10.0):
        self.opts = opts
        self.recon = recon
        self._lock = threading.Lock()
        # the identity camera (az = el = 0, distance 1.2) of single-image input;
        # DISN projects with the full camera matrix and rotates its queries
        rot, proj = camera.camera_matrices(0.0, 0.0, 1.2)
        self._rot = rot.astype(np.float32)
        self._proj = proj.astype(np.float32)
        self._full_proj = camera.full_projection_matrix(0.0, 0.0, 1.2).astype(np.float32)
        self.batch_size = int(recon.batch_size)
        self.batch_window_s = float(batch_window_ms) / 1e3
        self._stats_lock = threading.Lock()  # request threads append, /healthz reads
        self._served = 0
        self._errors = 0
        self._lat = deque(maxlen=256)  # seconds, completed requests
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        if self.batch_size > 1:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._batch_loop, daemon=True)
            self._worker.start()

    def close(self) -> None:
        """Stop the micro-batching thread (requests queued before it finish)."""
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None

    def warmup(self) -> None:
        """One padded batch of a blank image: builds the kernels and the
        mesh library before the first request."""
        img = np.zeros((self.opts.img_size, self.opts.img_size, 3), np.float32)
        with self._lock:
            self.recon.reconstruct_batch([self._feed_of(img)] * self.batch_size)

    # -- micro-batching ---------------------------------------------------

    def _batch_loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            group = [first]
            deadline = time.monotonic() + self.batch_window_s
            stop = False
            while len(group) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                group.append(item)
            feeds = [p.feed for p in group]
            feeds += [feeds[-1]] * (self.batch_size - len(feeds))
            try:
                with self._lock:
                    results = self.recon.reconstruct_batch(feeds)
            except Exception as err:  # noqa: BLE001 - reported to every waiter, serving goes on
                for p in group:
                    p.error = err
                    p.event.set()
            else:
                for p, result in zip(group, results):
                    p.result = result
                    p.event.set()
            if stop:
                return

    # -- requests ---------------------------------------------------------

    def preprocess(self, img_bytes: bytes, center: bool = True) -> np.ndarray:
        """Image bytes -> (img_size, img_size, 3) float32 in [-1, 1]."""
        img = decode_image(img_bytes)
        if center and img.ndim == 3 and img.shape[-1] == 4:
            img = center_rgba(img)
        return preprocess_image(img, self.opts.img_size, self.opts.use_white_bg)

    def _feed_of(self, img: np.ndarray) -> Dict[str, np.ndarray]:
        if self.opts.name_model == "disn":
            return {"img_input": img.astype(np.float32), "trans_mat_right": self._full_proj,
                    "obj_rot_mat": self._rot}
        return {"img_input": img.astype(np.float32), "trans_mat_wo_rot_tp": self._proj}

    def reconstruct_array(self, img: np.ndarray) -> Tuple[Mesh, Dict]:
        feed = self._feed_of(img)
        if self._queue is not None:
            pending = _PendingRequest(feed)
            self._queue.put(pending)
            pending.event.wait()
            if pending.error is not None:
                raise pending.error
            return pending.result
        with self._lock:
            return self.recon.reconstruct(feed)

    def reconstruct(self, img_bytes: bytes, center: bool = True) -> Tuple[str, Dict]:
        """Image bytes -> (OBJ text, numeric stats)."""
        t0 = time.perf_counter()
        try:
            mesh, stats = self.reconstruct_array(self.preprocess(img_bytes, center))
        except Exception:
            with self._stats_lock:
                self._errors += 1
            raise
        with self._stats_lock:
            self._lat.append(time.perf_counter() - t0)
            self._served += 1
        return obj_string(mesh), {k: v for k, v in stats.items()
                                  if isinstance(v, (int, float, np.integer, np.floating))}

    def serving_stats(self) -> Dict:
        with self._stats_lock:
            lat: List[float] = sorted(self._lat)
            served, errors = self._served, self._errors

        def pct(p):
            return round(lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3, 1)

        out = {"served": served, "errors": errors}
        if lat:
            out.update(p50_ms=pct(0.5), p90_ms=pct(0.9))
        return out


def build_service(opts: Options, batch_window_ms: float = 10.0,
                  device: str = "cuda") -> Slice3DService:
    """The service of ``opts`` on ``device`` (CUDA unless asked otherwise):
    its model with weights from ``--name_ckpt`` (or the seeded init), and a
    ``Reconstructor`` of batch ``--mc_batch_size``, sharded over the cards as
    ``parallel.reconstruction_mesh`` picks (``--mc_shard_axis``)."""
    if opts.name_model not in ("slicenet", "disn"):
        raise SystemExit("the service needs a single-image model (slicenet or disn): the "
                         "gtslice/LDM route needs slice images per request")
    from .models.build import load_model
    from .parallel import device_count, reconstruction_mesh
    from .pipeline import Reconstructor

    ckpt_path = os.path.join(opts.exp_dir, "ckpt", opts.name_ckpt) if opts.name_ckpt else None
    batch = max(1, opts.mc_batch_size)
    mesh = reconstruction_mesh(opts.mc_shard_axis, batch, opts.mc_chunk_size,
                               device_count(device))
    recon = Reconstructor(load_model(opts, ckpt_path), resolution0=opts.mc_res0,
                          upsampling_steps=opts.mc_up_steps, threshold=opts.mc_threshold,
                          chunk_size=opts.mc_chunk_size, batch_size=batch,
                          simplify_nfaces=opts.simplify_nfaces,
                          refine_steps=opts.mc_refine_steps, extract_method=opts.mc_extract,
                          device=device, mesh=mesh, shard_axis=opts.mc_shard_axis)
    return Slice3DService(opts, recon, batch_window_ms=batch_window_ms)


def make_handler(service: Slice3DService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype: str, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._send(404, b"not found", "text/plain")
            o = service.opts
            info = {"ok": True, "model": o.name_model, "img_size": o.img_size,
                    "mc_res0": o.mc_res0, "mc_up_steps": o.mc_up_steps,
                    "batch_size": service.batch_size,
                    "batch_window_ms": service.batch_window_s * 1e3,
                    "device": str(service.recon.device), **service.serving_stats()}
            self._send(200, json.dumps(info).encode(), "application/json")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/reconstruct":
                return self._send(404, b"not found", "text/plain")
            q = parse_qs(url.query)
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                obj, stats = service.reconstruct(body, center=q.get("center", ["1"])[0] != "0")
            except Exception as err:  # noqa: BLE001 - a bad image, reported to the client
                return self._send(400, str(err).encode(), "text/plain")
            hdr = {"X-Slice3D-Stats": json.dumps(stats)}
            if q.get("format", [""])[0] == "json":
                payload = json.dumps({"obj": obj, "stats": stats}).encode()
                return self._send(200, payload, "application/json", hdr)
            self._send(200, obj.encode(), "text/plain", hdr)

    return Handler


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--batch_window_ms", type=float, default=10.0,
                        help="micro-batch collection window when --mc_batch_size > 1")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    srv_args, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)
    service = build_service(opts, batch_window_ms=srv_args.batch_window_ms,
                            device=srv_args.device)
    print("warming up (kernels and mesh library build on the first batch) ...", flush=True)
    service.warmup()
    server = ThreadingHTTPServer((srv_args.host, srv_args.port), make_handler(service))
    print(f"serving {opts.name_model} on http://{srv_args.host}:{server.server_address[1]} "
          f"({service.recon.device}, res0 {opts.mc_res0}, up {opts.mc_up_steps}, batch "
          f"{service.batch_size})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
