"""Standalone examples (ports of `examples/mini_renderer.py` and
`examples/mini_neural.py`)."""
