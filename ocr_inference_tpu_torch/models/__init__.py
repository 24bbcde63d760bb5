"""Networks (UNet, DeepLabV3+, the Easter2 family, CRNN) and the
Flax-msgpack weight reader."""
