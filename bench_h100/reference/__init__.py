"""The benchmark's plain reference: frozen copies of the port's PointRCNN and
SECOND modules in plain PyTorch, float32, with the plain furthest point
sampling loop in place of the port's CUDA kernel. Nothing here imports the
port; ``harness/guard.py`` checks that in every run."""
