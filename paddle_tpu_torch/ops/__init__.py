"""paddle_tpu_torch.ops — the functional ops the port's layers are
built from, at the JAX package's module paths (`paddle_tpu/ops/`):
`linalg.matmul`, `activation.gelu` / `tanh`, `loss_ops.cross_entropy`,
`norm_ops.layer_norm`. Each op hands its tensor inputs to
`amp.maybe_cast_inputs` under its JAX op name first, as the JAX
dispatcher does, so `amp.auto_cast` (O1) sees it."""
