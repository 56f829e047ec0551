"""Multi-device layer of the port. Only the example inputs are here so far;
the sharded kernels (torch.distributed) are ROADMAP queue 1 item 4."""
