"""Checkpoints, metrics logging, curves and the msgpack reader."""
