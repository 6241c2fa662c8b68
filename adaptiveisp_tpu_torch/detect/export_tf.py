"""TensorFlow-interchange export (the names of
``adaptiveisp_tpu/detect/export_tf.py``): SavedModel, frozen GraphDef,
TFLite.

The JAX package lowers its jitted forward to TensorFlow with ``jax2tf``.
PyTorch has no such route among the installed packages: no ``onnx`` or
``onnx-tf`` converter, and no TensorFlow on the machine with the card.  So
each function here keeps the JAX package's name and raises, naming the
format that does exist: the ``torch.export`` program (``pt2``,
``detect/export.py``), which a converter would take as its input.
"""

from __future__ import annotations

_MESSAGE = ("{fmt} export needs a PyTorch -> TensorFlow converter (onnx + "
            "onnx-tf, or TensorFlow itself), and none is installed; the "
            "port exports `pt2` (torch.export, detect/export.py) and "
            "`variables`")


def _unavailable(fmt: str):
    raise NotImplementedError(_MESSAGE.format(fmt=fmt))


def export_saved_model(fn, example_args, path: str, platforms=("cpu",)):
    _unavailable("TF SavedModel")


def export_graphdef(fn, example_args, path: str):
    _unavailable("frozen GraphDef")


def export_tflite(fn, example_args, path: str, mode: str = "fp32",
                  representative_data=None, allow_flex: bool = True):
    _unavailable(f"TFLite ({mode})")


def run_saved_model(path: str, *args):
    _unavailable("TF SavedModel")


def run_tflite(path: str, *args):
    _unavailable("TFLite")


def export_detector_tf(model, out_dir: str, spec=None, imgsz: int = 512,
                       batch: int = 1, formats=("saved_model", "tflite")):
    _unavailable("TensorFlow (" + ", ".join(formats) + ")")
