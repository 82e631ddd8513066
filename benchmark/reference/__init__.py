"""The benchmark's plain reference: a frozen copy of the port's model,
train and eval steps, optimizer and solvers, taken when the benchmark was
defined and kept here so that no later change to the port moves it.

It imports torch and numpy only: nothing of the port, of the JAX package or
of JAX. Its departures from the port it was copied from: the neighbour
aggregation is always the unfused module chain (`ConditionalNeRF.query`;
no CUDA kernel, no plain version of the kernel), there is no
`simple_3d_model` and no YAML reader. The benchmark runs it at float32 with
TF32 off, on the weights, inputs and noise it hands the port.
"""
