"""The key-compatible RNG and the device constants."""
