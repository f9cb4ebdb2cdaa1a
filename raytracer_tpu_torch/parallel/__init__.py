"""Training over the differentiable renderer (single device)."""
