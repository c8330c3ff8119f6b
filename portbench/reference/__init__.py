"""The plain reference: f32 / f64 PyTorch, independent of the port.

Nothing here imports the port (``tgq_torch``), the JAX package or JAX;
the harness hands it the inputs it made and the outputs it judges as
plain tensors."""
