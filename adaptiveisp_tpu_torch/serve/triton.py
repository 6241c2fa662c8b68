"""Triton Inference Server client over KServe v2 HTTP (port of
``adaptiveisp_tpu/serve/triton.py``).

The reference's ``TritonRemoteModel`` (yolov3/utils/triton.py:11-85) wraps
the ``tritonclient`` package, which is not installed here; like the JAX
package's, this one speaks the protocol itself in the standard library
(``urllib``, ``json``): the KServe v2 inference protocol
(``/v2/models/...``) with the binary tensor extension for the request's
inputs and the response's outputs.  Tensors go in (NumPy arrays too) and
come out as tensors on the device of the first input.

    model = TritonRemoteModel("http://localhost:8000")   # first repo model
    out = model(torch.zeros(1, 640, 640, 3))             # positional
    out = model(images=x)                                # or by input name
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np
import torch

# KServe v2 datatype <-> numpy (the JAX package's table)
_DTYPES = {
    "BOOL": np.bool_, "UINT8": np.uint8, "UINT16": np.uint16,
    "UINT32": np.uint32, "UINT64": np.uint64, "INT8": np.int8,
    "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
}
_NP2DT = {np.dtype(v): k for k, v in _DTYPES.items()}


def _np_dtype(datatype: str):
    try:
        return _DTYPES[datatype]
    except KeyError:
        raise ValueError(f"unsupported Triton datatype {datatype!r}")


def _to_numpy(name: str, v) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array whose type the
    datatype table holds."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError(
                f"input {name!r} is bfloat16, which has no KServe v2 "
                f"datatype in this client's table; cast it to float16 or "
                f"float32")
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.dtype not in _NP2DT:
        raise TypeError(f"input {name!r}: dtype {arr.dtype} has no KServe "
                        f"v2 datatype in this client's table")
    return arr


class TritonRemoteModel:
    """Tensor-in / tensor-out call wrapper over one served model.

    url: ``http://host:port`` (KServe v2 REST).  The reference also takes
    grpc:// through the tritonclient package; gRPC needs protobuf code
    generation that is not installed here, so it is refused clearly.
    """

    def __init__(self, url: str, model_name: Optional[str] = None):
        if "://" not in url:
            url = "http://" + url  # bare host:port
        parsed = urlparse(url)
        if parsed.scheme == "grpc":
            raise NotImplementedError(
                "grpc:// needs the tritonclient package (not installed); "
                "use the http:// KServe v2 endpoint")
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme {parsed.scheme!r}")
        self.base = f"{parsed.scheme}://{parsed.netloc}"
        if model_name is None:
            index = self._post_json("/v2/repository/index", {})
            if not index:
                raise RuntimeError("Triton model repository is empty")
            model_name = index[0]["name"]
        self.model_name = model_name
        self.metadata = self._get_json(f"/v2/models/{model_name}")

    @property
    def runtime(self):
        """The model's runtime or backend (reference triton.py:52-54)."""
        return self.metadata.get("backend", self.metadata.get("platform"))

    @property
    def input_names(self) -> List[str]:
        return [i["name"] for i in self.metadata["inputs"]]

    def __call__(self, *args, **kwargs):
        """Run inference; positional arguments follow the model's input
        order, keyword arguments match input names (reference
        triton.py:56-67).  Returns one tensor, or a tuple in the metadata's
        output order, on the first input's device (the CPU for arrays)."""
        if args and kwargs:
            raise RuntimeError(
                "Cannot specify args and kwargs at the same time")
        if not args and not kwargs:
            raise RuntimeError("No inputs provided.")
        inputs = self.metadata["inputs"]
        if args:
            if len(args) != len(inputs):
                raise RuntimeError(
                    f"Expected {len(inputs)} inputs, got {len(args)}.")
            given = [(i["name"], v) for i, v in zip(inputs, args)]
        else:
            given = [(i["name"], kwargs[i["name"]]) for i in inputs]
        first = given[0][1]
        device = (first.device if isinstance(first, torch.Tensor)
                  else torch.device("cpu"))
        tensors = {name: _to_numpy(name, v) for name, v in given}

        body, header = _encode_infer_request(
            tensors, output_names=[o["name"]
                                   for o in self.metadata["outputs"]])
        raw = self._post_raw(
            f"/v2/models/{self.model_name}/infer", body,
            {"Content-Type": "application/octet-stream",
             "Inference-Header-Content-Length": str(header)})
        outputs = _decode_infer_response(raw)
        result = [torch.from_numpy(np.array(outputs[o["name"]])).to(device)
                  for o in self.metadata["outputs"]]
        return result[0] if len(result) == 1 else tuple(result)

    def _get_json(self, path: str):
        with urllib.request.urlopen(self.base + path) as r:
            return json.loads(r.read())

    def _post_json(self, path: str, payload):
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base + path, data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    def _post_raw(self, path: str, body: bytes, headers: Dict[str, str]):
        req = urllib.request.Request(self.base + path, data=body,
                                     headers=headers)
        with urllib.request.urlopen(req) as r:
            # lower-case keys: dict() loses HTTPMessage's case-insensitive
            # lookup, and proxies may rewrite the casing
            return r.read(), {k.lower(): v for k, v in r.headers.items()}


# --------------------------------------------------------------------------- #
# KServe v2 wire format (a JSON header, then the binary tensor blobs)
# --------------------------------------------------------------------------- #
def _encode_infer_request(tensors: Dict[str, np.ndarray],
                          output_names=None) -> Tuple[bytes, int]:
    """-> (body, json_header_length) with binary_data_size extensions.

    output_names (when given) adds an outputs section requesting
    binary_data: without it Triton embeds output tensors in the JSON
    (failing outright for FP16, and bloating large outputs)."""
    header = {"inputs": []}
    if output_names:
        header["outputs"] = [
            {"name": n, "parameters": {"binary_data": True}}
            for n in output_names]
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        blob = arr.tobytes()
        header["inputs"].append({
            "name": name,
            "shape": list(arr.shape),
            "datatype": _NP2DT[arr.dtype],
            "parameters": {"binary_data_size": len(blob)},
        })
        blobs.append(blob)
    hdr = json.dumps(header).encode()
    return hdr + b"".join(blobs), len(hdr)


def _decode_infer_response(raw: Tuple[bytes, Dict[str, str]]
                           ) -> Dict[str, np.ndarray]:
    body, headers = raw
    # case-insensitive header lookup (proxies rewrite casing)
    hlen = next((v for k, v in headers.items()
                 if k.lower() == "inference-header-content-length"), None)
    hlen = int(hlen) if hlen else len(body)
    meta = json.loads(body[:hlen])
    out: Dict[str, np.ndarray] = {}
    offset = hlen
    for o in meta.get("outputs", []):
        shape = [int(s) for s in o["shape"]]
        dt = _np_dtype(o["datatype"])
        bsize = (o.get("parameters") or {}).get("binary_data_size")
        if bsize is not None:
            arr = np.frombuffer(body[offset:offset + bsize], dtype=dt)
            offset += bsize
            out[o["name"]] = arr.reshape(shape)
        else:  # JSON-embedded data
            out[o["name"]] = np.asarray(o["data"], dtype=dt).reshape(shape)
    return out


__all__ = ["TritonRemoteModel"]
