"""The port's Triton client against the JAX package's, on the in-process
mock KServe-v2 server of ``tests/test_triton_client.py``: the same outputs
for the same inputs (tensors out, on the first input's device), request
bodies byte-equal to JAX's ``_encode_infer_request``, case-insensitive
response headers, and the refusals (``grpc://``, ``bfloat16``)."""

import json
import threading
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from adaptiveisp_tpu.serve import triton as jtriton
from adaptiveisp_tpu_torch.serve import triton as ttriton
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401
from test_triton_client import _Handler


@pytest.fixture(scope="module")
def server():
    httpd = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()


def test_outputs_equal_jax_client(server):
    port, jax_client = (ttriton.TritonRemoteModel(server),
                        jtriton.TritonRemoteModel(server))
    assert (port.model_name, port.runtime, port.input_names) == (
        jax_client.model_name, jax_client.runtime, jax_client.input_names)
    x = np.random.RandomState(0).rand(1, 8, 8, 3).astype(np.float32)
    want = jax_client(x)
    for args, kwargs in (((torch.from_numpy(x),), {}),
                         ((), {"images": torch.from_numpy(x)}), ((x,), {})):
        got = port(*args, **kwargs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), w)


def test_request_bodies_equal_jax_encoder():
    tensors = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
               "b": np.ones((4,), np.float16),
               "c": np.random.RandomState(1).rand(2, 5).astype(np.float32)}
    for outs in (None, ["o1", "o2"]):
        assert ttriton._encode_infer_request(tensors, outs) == \
            jtriton._encode_infer_request(tensors, outs)
    body, hlen = ttriton._encode_infer_request(tensors, ["a"])
    meta = json.loads(body[:hlen])
    resp = json.dumps({"outputs": meta["inputs"]}).encode()
    for key in ("Inference-Header-Content-Length",
                "INFERENCE-HEADER-CONTENT-LENGTH"):
        raw = (resp + body[hlen:], {key: str(len(resp))})
        got, want = (ttriton._decode_infer_response(raw),
                     jtriton._decode_infer_response(raw))
        assert got.keys() == want.keys() == tensors.keys()
        for k in tensors:
            np.testing.assert_array_equal(got[k], want[k])


def test_refusals_and_input_checks(server):
    with pytest.raises(NotImplementedError, match="grpc"):
        ttriton.TritonRemoteModel("grpc://localhost:8001")
    m = ttriton.TritonRemoteModel(server)
    with pytest.raises(TypeError, match="bfloat16"):
        m(torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16))
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(RuntimeError):
        m()
    with pytest.raises(RuntimeError):
        m(x, images=x)
    with pytest.raises(RuntimeError):
        m(x, x)
