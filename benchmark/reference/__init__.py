"""The plain reference: plain PyTorch, float32 with TF32 off, written from
the published equations. It imports nothing of the system under test."""
