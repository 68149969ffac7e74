"""MJPEG network display: stream a progressive render over HTTP
(corona13_tpu/tools/netdisplay.py).

The analogue of the reference's mjpeg display module + netrender client
(corona-13 src/display.d/mjpeg.c:112-151, default port 8090;
tools/corona-netrender): the renderer's crash-safe ``.fb`` accumulation
file IS the live progressive state (include/framebuffer.h), so the
display is a separate process that watches the file and serves
``multipart/x-mixed-replace`` JPEG frames — open
``http://host:8090/`` in any browser while a render runs:

    python -m corona13_tpu_torch scene.nra2 -s 512 -x out &
    python -m corona13_tpu_torch.tools.netdisplay out.fb --port 8090

Tonemapping matches RenderResult.image_srgb (XYZ -> sRGB + gamma), on
the CPU.  JPEG encoding needs Pillow, imported at the first frame.
"""

from __future__ import annotations

import argparse
import io
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _tonemap(img_xyz: np.ndarray, gain: float = 1.0) -> np.ndarray:
    import torch
    from ..spectral import colour
    lin = colour.convert(torch.as_tensor(img_xyz * gain), 'xyz', 'srgb')
    srgb = colour.srgb_gamma(torch.clamp(lin, min=0.0)).numpy()
    return (np.clip(srgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _encode_jpeg(rgb8: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb8, 'RGB').save(buf, 'JPEG', quality=quality)
    return buf.getvalue()


class _FbWatcher(threading.Thread):
    """Poll the .fb file; keep the latest encoded JPEG frame."""

    def __init__(self, path: str, fps: float, gain: float):
        super().__init__(daemon=True)
        self.path = path
        self.interval = 1.0 / max(fps, 0.1)
        self.gain = gain
        self.frame = None
        self.spp = 0
        self._stop = threading.Event()

    def run(self):
        from ..io import fb as fb_io
        last_mtime = 0.0
        while not self._stop.is_set():
            try:
                import os
                m = os.path.getmtime(self.path)
                if m != last_mtime:
                    last_mtime = m
                    fb = fb_io.Framebuffer.load(self.path)
                    img = fb.data * (fb.gain if fb.gain > 0 else
                                     1.0 / max(fb.spp, 1))
                    self.frame = _encode_jpeg(_tonemap(img, self.gain))
                    self.spp = fb.spp
            except (FileNotFoundError, ValueError):
                pass
            time.sleep(self.interval)

    def stop(self):
        self._stop.set()


def make_handler(watcher: _FbWatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path not in ('/', '/stream', '/frame.jpg'):
                self.send_error(404)
                return
            if self.path == '/frame.jpg':
                frame = watcher.frame or b''
                self.send_response(200)
                self.send_header('Content-Type', 'image/jpeg')
                self.send_header('Content-Length', str(len(frame)))
                self.end_headers()
                self.wfile.write(frame)
                return
            # multipart MJPEG stream (mjpeg.c's content type)
            self.send_response(200)
            self.send_header('Content-Type',
                             'multipart/x-mixed-replace; boundary=frame')
            self.end_headers()
            try:
                while True:
                    frame = watcher.frame
                    if frame:
                        self.wfile.write(b'--frame\r\n')
                        self.wfile.write(b'Content-Type: image/jpeg\r\n')
                        self.wfile.write(
                            f'Content-Length: {len(frame)}\r\n\r\n'.encode())
                        self.wfile.write(frame)
                        self.wfile.write(b'\r\n')
                    time.sleep(watcher.interval)
            except (BrokenPipeError, ConnectionResetError):
                pass
    return Handler


def serve(fb_path: str, port: int = 8090, fps: float = 2.0,
          gain: float = 1.0, run_forever: bool = True):
    watcher = _FbWatcher(fb_path, fps, gain)
    watcher.start()
    httpd = ThreadingHTTPServer(('0.0.0.0', port), make_handler(watcher))
    if run_forever:
        print(f'[netdisplay] serving {fb_path} on http://0.0.0.0:{port}/')
        try:
            httpd.serve_forever()
        finally:
            watcher.stop()
    return httpd, watcher


def main(argv=None):
    p = argparse.ArgumentParser(prog='netdisplay')
    p.add_argument('fb', help='.fb progressive framebuffer to watch')
    p.add_argument('--port', type=int, default=8090)
    p.add_argument('--fps', type=float, default=2.0)
    p.add_argument('--gain', type=float, default=1.0)
    args = p.parse_args(argv)
    serve(args.fb, args.port, args.fps, args.gain)


if __name__ == '__main__':
    sys.exit(main())
