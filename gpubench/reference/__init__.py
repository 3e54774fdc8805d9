"""The plain reference that the port's results are held to: plain
PyTorch, float32 with TF32 off, importing nothing of the port."""
