"""PyTorch/CUDA port of ocr_inference_tpu for one NVIDIA H100.

A second package beside the JAX reference (``ocr_inference_tpu``), with the
same module names so each counterpart is easy to find. It imports torch,
numpy, scipy and the standard library only, and nothing of the JAX
package: what it needs from there it carries as its own copy.

Entry points::

    from ocr_inference_tpu_torch.pipeline import VolumeRunner, build_pipeline
    pipe = build_pipeline(ocr_config, line_config)          # device="cuda"
    status, payload = pipe.run_ocr(page_rgb_u8)             # one page
    status, payload = pipe.run_ocr(page_rgb_u8, eval_mode=True)  # beams
    records = VolumeRunner(pipe).run([(name, page_or_loader), ...])

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
missing card with no CPU request raises (``device.resolve_device``).
"""
