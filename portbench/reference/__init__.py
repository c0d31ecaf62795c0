"""The plain reference: the same semantics as the served path, written
anew in plain PyTorch. It imports nothing of the port, of the JAX package
or of JAX, and takes none of the port's derived data (no int8 codes, no
row layout, no capacity tier): it reads the inputs that the harness draws
from the seed, and the port's outputs only to judge them."""
