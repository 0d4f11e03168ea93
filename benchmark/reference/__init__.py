"""Plain PyTorch references (float32, no kernels, no cache, no batching).

They read the benchmark's own seeded tensors in the published layouts and
work out again what the program derives from them at set-up (int8 weights,
int8 cross-KV); they import nothing of the program.
"""
