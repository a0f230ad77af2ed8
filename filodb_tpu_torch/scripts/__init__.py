"""Operational tools that run against a live port deployment
(``python -m filodb_tpu_torch.scripts.<name>``)."""
