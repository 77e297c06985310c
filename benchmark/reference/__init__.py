"""The benchmark's plain reference: a frozen copy of the port's oracle
(zang_tpu_torch/oracle/, csrc/zang_oracle.cpp and the host core it reads),
with the renders of each cell in renders.py. It imports numpy, ctypes and
its own modules: nothing of zang_tpu_torch and nothing of JAX, so a later
change to the port cannot move the yardstick. Its C++ builds with g++ into
benchmark/.build/.
"""
