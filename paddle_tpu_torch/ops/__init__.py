"""paddle_tpu_torch.ops — the functional ops the port's layers are
built from, at the JAX package's module paths (`paddle_tpu/ops/`):
`linalg.matmul`, `activation.gelu` / `relu` / `tanh`,
`loss_ops.cross_entropy` / `softmax_with_cross_entropy`,
`norm_ops.layer_norm` / `batch_norm`,
`conv.conv1d` / `conv2d` / `conv3d` / `max_pool2d` / `avg_pool2d` /
`adaptive_avg_pool2d`, `manipulation.flatten`. Each op hands its tensor
inputs to `amp.maybe_cast_inputs` under its JAX op name first, as the
JAX dispatcher does, so `amp.auto_cast` (O1) sees it."""
