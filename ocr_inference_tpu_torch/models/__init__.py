"""Networks (UNet, Easter2) and the Flax-msgpack weight reader."""
