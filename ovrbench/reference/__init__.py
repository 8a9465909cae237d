"""The plain reference of the renderer: plain PyTorch, float32, given
only the benchmark's inputs."""
