"""Exporter-made ONNX graphs for the port's ONNX tests, with what each is
held against: the JAX package's torch twins (models/torch_twins.py)
through the TorchScript exporter, folded and fold-free, in the tf2onnx
dialect (tests/tf_exporter_sim.py) and in fp16, at the sizes the JAX
package's own ONNX tests use.

``twin_case(name, directory)`` exports one and returns a ``TwinCase``:
the graph's path, its input, the torch twin's output on it (the JAX
test's oracle), the JAX module and its input (NHWC where Flax wants it),
and the port's module and its input.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

H, W, V = 16, 64, 17


def randomize_bn(tm: torch.nn.Module) -> None:
    """Running statistics away from 0 / 1, so that folding matters."""
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)


@dataclass
class TwinCase:
    path: Path
    graph_x: np.ndarray  # what the graph takes
    ref: np.ndarray  # the twin's output on graph_x, in the graph's layout
    jax_module: Callable  # () -> a fresh Flax module
    jax_x: np.ndarray
    port_module: Callable  # () -> a fresh port module (float32, eval)
    port_x: np.ndarray


def _easter2(vocab=V, **kw):
    import jax.numpy as jnp

    from ocr_inference_tpu.models.recognition import Easter2

    return Easter2(vocab_size=vocab, dtype=jnp.float32, **kw)


def _port_easter2(vocab=V, **kw):
    from ocr_inference_tpu_torch.models.recognition import Easter2

    return Easter2(vocab, H, **kw).eval()


def twin_case(name: str, d: Path) -> TwinCase:
    import jax.numpy as jnp

    from ocr_inference_tpu.models import recognition as jr
    from ocr_inference_tpu.models import segmentation as js
    from ocr_inference_tpu.models import torch_twins as tw
    from ocr_inference_tpu_torch.models import recognition as pr
    from ocr_inference_tpu_torch.models import segmentation as ps
    from ocr_inference_tpu_torch.onnx.export_shim import torch_export
    from tests.tf_exporter_sim import tf_export_easter2, tf_export_unet

    path = d / f"{name}.onnx"
    seq = np.random.RandomState(0).randn(2, H, W).astype(np.float32) * 0.5
    img = np.random.RandomState(1).rand(1, 3, 64, 64).astype(np.float32)
    nhwc = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    torch.manual_seed(sum(map(ord, name)))
    if name.startswith(("easter2", "tf_easter2", "fp16_easter2")):
        tm = tw.TEaster2(H, W, V).eval()
        randomize_bn(tm)
        if name.startswith("tf_"):
            tf_export_easter2(tm, path)
            graph_x = np.ascontiguousarray(seq.transpose(0, 2, 1))
        elif name.startswith("fp16_"):
            tm = tm.half()
            torch_export(tm, torch.randn(2, H, W).half(), str(path),
                         do_constant_folding=False)
            graph_x = seq.astype(np.float16)
        else:
            torch_export(tm, torch.randn(2, H, W), str(path),
                         do_constant_folding=name.endswith("_fold"))
            graph_x = seq
        with torch.no_grad():
            ref = tm(torch.from_numpy(seq).to(next(tm.parameters()).dtype))
        ref = ref.float().numpy()
        if name.startswith("tf_"):
            ref = ref.transpose(0, 2, 1)  # the tf graph emits (B, T, V)
        return TwinCase(path, graph_x, ref, _easter2, seq, _port_easter2,
                        seq)
    if name == "attention":
        tm = tw.TEaster2Attention(H, W, 13, ln_eps=1e-6).eval()
        randomize_bn(tm)
        torch_export(tm, torch.randn(2, H, W), str(path),
                     do_constant_folding=False)
        with torch.no_grad():
            ref = tm(torch.from_numpy(seq)).numpy()
        return TwinCase(path, seq, ref,
                        lambda: _easter2(13, variant="attention"), seq,
                        lambda: _port_easter2(13, variant="attention"), seq)
    if name.startswith(("unet", "tf_unet")):
        stem = 2 if name.endswith("stem2") else 1
        tm = tw.TUNet(width=8, stem_stride=stem).eval()
        randomize_bn(tm)
        if name.startswith("tf_"):
            tf_export_unet(tm, path)
            graph_x = nhwc
        else:
            torch_export(tm, torch.randn(1, 3, 64, 64), str(path),
                         do_constant_folding=not name.endswith("nofold"))
            graph_x = img
        with torch.no_grad():
            ref = tm(torch.from_numpy(img)).numpy()
        if name.startswith("tf_"):
            ref = ref.transpose(0, 2, 3, 1)
        return TwinCase(
            path, graph_x, ref,
            lambda: js.UNet(classes=1, width=8, stem_stride=stem,
                            dtype=jnp.float32), nhwc,
            lambda: ps.UNet(1, 8, stem).eval(), img)
    if name == "crnn":
        tm = tw.TCRNN(32, 11, hidden=8).eval()
        randomize_bn(tm)
        x = np.random.RandomState(2).randn(2, 1, 32, 64).astype(
            np.float32) * 0.5
        torch_export(tm, torch.randn(2, 1, 32, 64), str(path))
        with torch.no_grad():
            ref = tm(torch.from_numpy(x)).numpy()
        return TwinCase(
            path, x, ref,
            lambda: jr.CRNN(vocab_size=11, hidden=8, dtype=jnp.float32),
            x[:, 0], lambda: pr.CRNN(11, 32, hidden=8).eval(), x[:, 0])
    if name == "deeplab":
        tm = tw.TDeepLabV3Plus(hw=(64, 64), classes=5).eval()
        randomize_bn(tm)
        torch_export(tm, torch.randn(1, 3, 64, 64), str(path))
        with torch.no_grad():
            ref = tm(torch.from_numpy(img)).numpy()
        return TwinCase(
            path, img, ref,
            lambda: js.DeepLabV3Plus(classes=5, dtype=jnp.float32), nhwc,
            lambda: ps.DeepLabV3Plus(5).eval(), img)
    raise KeyError(name)


TWINS = ("easter2_fold", "easter2_nofold", "attention", "unet",
         "unet_nofold", "crnn", "deeplab", "tf_easter2", "tf_unet_stem2",
         "fp16_easter2")
