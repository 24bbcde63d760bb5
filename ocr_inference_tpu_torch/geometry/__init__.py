"""Host-side line geometry: contours, skew, reading order, extraction."""
