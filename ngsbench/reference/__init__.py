"""The benchmark's plain reference: 3D Gaussian splatting in float32
PyTorch (``render``) and its training steps (``train``). It imports
nothing of the program and takes nothing the program made."""
