"""Data model and constants (copies of ocr_inference_tpu.core)."""
