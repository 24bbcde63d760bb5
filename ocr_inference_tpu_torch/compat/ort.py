"""``onnxruntime``-compatible module surface over the port's ONNX executor.

Counterpart of ocr_inference_tpu/compat/ort.py. Implements the API the
reference stack consumes (reference: BDRC/inference.py:127-130,152-157,
294,359-365; BDRC/utils.py:220-229): ``InferenceSession`` with ``run`` /
``run_with_ort_values`` / ``get_inputs`` / ``get_outputs``,
``OrtValue.ortvalue_from_numpy`` and ``get_available_providers``. Graphs
run through ``ocr_inference_tpu_torch.onnx.runner.OnnxGraphFunction``: on
the card when ``CUDAExecutionProvider`` leads the session's providers (the
default when a card is present), on the CPU otherwise, as onnxruntime
picks its device from the providers.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

__version__ = "0.0-ocr_inference_tpu_torch-compat"

CUDA = "CUDAExecutionProvider"
CPU = "CPUExecutionProvider"


def get_available_providers() -> list[str]:
    return ([CUDA] if torch.cuda.is_available() else []) + [CPU]


def get_device() -> str:
    return "GPU" if CUDA in get_available_providers() else "CPU"


class OrtValue:
    """Host-array holder mirroring onnxruntime.OrtValue's consumed API."""

    def __init__(self, array):
        self._array = np.asarray(array)

    @staticmethod
    def ortvalue_from_numpy(array, device_type: str = "cpu",
                            device_id: int = 0):
        return OrtValue(array)

    def numpy(self) -> np.ndarray:
        return self._array

    def shape(self):
        return list(self._array.shape)


class NodeArg:
    def __init__(self, name: str, shape, elem_type: str = "tensor(float)"):
        self.name = name
        self.shape = shape
        self.type = elem_type


class SessionOptions:
    """Accepted and ignored: the executor has no session-level knobs."""

    def __init__(self):
        self.log_severity_level = 2
        self.intra_op_num_threads = 0
        self.inter_op_num_threads = 0


class InferenceSession:
    """onnxruntime.InferenceSession drop-in over the port's graph
    executor, one executor per requested output set."""

    def __init__(
        self,
        path_or_bytes,
        sess_options: Optional[SessionOptions] = None,
        providers: Optional[Sequence[str]] = None,
        **_: Any,
    ):
        from ocr_inference_tpu_torch.onnx.runner import OnnxGraphFunction
        from ocr_inference_tpu_torch.onnx.wire import load_model, parse_model

        if isinstance(path_or_bytes, (bytes, bytearray)):
            model = parse_model(bytes(path_or_bytes))
        else:
            model = load_model(path_or_bytes)
        self._model = model
        self._providers = list(providers or get_available_providers())
        self._device = "cuda" if self._providers[0] == CUDA else "cpu"
        self._fn = OnnxGraphFunction(model, device=self._device)
        self._graph_outputs = list(self._fn.output_names)
        self._fns = {tuple(self._graph_outputs): self._fn}

    # -- introspection --

    def get_inputs(self) -> list[NodeArg]:
        infos = {vi.name: vi for vi in self._model.graph.inputs}
        return [NodeArg(name, list(infos[name].shape)
                        if name in infos else None)
                for name in self._fn.input_names]

    def get_outputs(self) -> list[NodeArg]:
        infos = {vi.name: vi for vi in self._model.graph.outputs}
        return [NodeArg(name, list(infos[name].shape)
                        if name in infos else None)
                for name in self._graph_outputs]

    def get_providers(self) -> list[str]:
        return self._providers

    # -- execution --

    def _fn_for(self, output_names: Optional[Sequence[str]]):
        from ocr_inference_tpu_torch.onnx.runner import OnnxGraphFunction

        key = tuple(output_names if output_names is not None
                    else self._graph_outputs)
        if key not in self._fns:
            self._fns[key] = OnnxGraphFunction(
                self._model, output_names=list(key), device=self._device)
        return self._fns[key]

    def _execute(self, output_names, input_feed: dict) -> list[np.ndarray]:
        fn = self._fn_for(output_names)
        args = []
        for name in self._fn.input_names:
            if name not in input_feed:
                raise ValueError(f"missing input {name!r}")
            value = input_feed[name]
            if isinstance(value, OrtValue):
                value = value.numpy()
            args.append(np.asarray(value))
        return [o.cpu().numpy() for o in fn(fn.weights, *args)]

    def run(self, output_names, input_feed: dict, run_options=None):
        return self._execute(output_names, input_feed)

    def run_with_ort_values(self, output_names, input_feed: dict,
                            run_options=None):
        return [OrtValue(o) for o in self._execute(output_names, input_feed)]

    def end_profiling(self) -> str:  # API parity only
        return ""
