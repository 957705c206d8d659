"""The plain reference of the benchmark's training cells: float32 PyTorch,
independent of the program (it imports nothing of ``repro_torch``)."""
