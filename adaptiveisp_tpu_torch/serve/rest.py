"""REST detection service (port of ``adaptiveisp_tpu/serve/rest.py``) on
the standard library's ``http.server``.

    POST /v1/object-detection/adaptiveisp   body: image bytes (png/jpeg)
      -> JSON [{xmin, ymin, xmax, ymax, confidence, class, name}, ...]
    GET  /healthz                            -> {"status": "ok"}

A body that is not an image gets 400; a failed inference 500 with a JSON
error.  Every request is letterboxed to the service size; with an
adaptive ISP the letterboxed image goes through ``AdaptiveISP.process``
on the card before detection, and the boxes are scaled back to the
original image.

    python -m adaptiveisp_tpu_torch.serve.rest --device cuda --port 5000 \\
        [--weights W] [--spec yolov3] [--isp_weights AGENT] [--imgsz 512]

or in a program: ``srv = DetectionServer(detector, port=0).start()``,
then ``srv.stop()``.  One worker: one device; requests queue.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np

ROUTE = "/v1/object-detection/adaptiveisp"


def infer(detector, im, size: int, conf_thres: float, isp=None):
    """Detections of one HWC float32 [0, 1] image as the service's JSON
    list; with ``isp`` the letterboxed image is retouched first."""
    if isp is None:
        return detector(im, size=size, conf_thres=conf_thres).to_dicts()[0]
    from adaptiveisp_tpu_torch.api import Detections
    from adaptiveisp_tpu_torch.data.letterbox import letterbox
    from adaptiveisp_tpu_torch.detect.boxes import scale_boxes

    h0, w0 = im.shape[:2]
    lb, ratio, pad = letterbox(im, size, color=(0, 0, 0))
    x = isp.process(lb[None])
    dets, nvalid = detector.detect(x, conf_thres=conf_thres)
    det = dets[0][:int(nvalid[0])].cpu().numpy()
    if det.shape[0]:
        det[:, :4] = scale_boxes((size, size), det[:, :4], (h0, w0),
                                 (ratio, pad))
    return Detections([im], [det], detector.names).to_dicts()[0]


def _make_handler(detector, size: int, conf_thres: float, isp=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path.rstrip("/") != ROUTE:
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                from PIL import Image

                im = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                                np.float32) / 255.0
            except Exception as e:
                self._json(400, {"error": f"bad image: {e}"})
                return
            try:
                payload = infer(detector, im, size, conf_thres, isp)
            except Exception as e:
                self._json(500, {"error": f"inference failed: {e}"})
                return
            self._json(200, payload)

    return Handler


class DetectionServer:
    """The service on a thread of its own (port 0: any free port)."""

    def __init__(self, detector, port: int = 5000, size: int = 512,
                 conf_thres: float = 0.25, isp=None):
        handler = _make_handler(detector, size, conf_thres, isp=isp)
        self.httpd = HTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def serve(weights: Optional[str] = None, spec=None, port: int = 5000,
          size: int = 512, conf_thres: float = 0.25,
          isp_weights: Optional[str] = None, device="cuda"):
    from adaptiveisp_tpu_torch import api

    detector = api.load_detector(weights=weights, spec=spec, device=device)
    isp = (api.load_adaptive_isp(isp_weights, device=device)
           if isp_weights else None)
    srv = DetectionServer(detector, port=port, size=size,
                          conf_thres=conf_thres, isp=isp)
    print(f"serving on http://127.0.0.1:{srv.port}{ROUTE}")
    return srv.start()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--weights", default=None)
    p.add_argument("--spec", default=None,
                   help="yolov3 | yolov3-tiny | yolov5s | spec.yaml")
    p.add_argument("--isp_weights", default=None)
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--conf_thres", type=float, default=0.25)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    spec = None
    if args.spec:
        from adaptiveisp_tpu_torch.detect.spec import resolve_spec

        spec = resolve_spec(args.spec)
    srv = serve(weights=args.weights, spec=spec, port=args.port,
                size=args.imgsz, conf_thres=args.conf_thres,
                isp_weights=args.isp_weights, device=args.device)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
