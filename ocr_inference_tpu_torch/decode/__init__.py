"""CTC decoding (greedy best path on the device)."""
