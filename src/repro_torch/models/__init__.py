"""Dense and MoE models of the PyTorch port: modules hold the weights,
plain functions run prefill and decode."""
