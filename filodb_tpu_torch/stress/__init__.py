"""The port's soaks (``python -m filodb_tpu_torch.stress.<name>``).

Each soak keeps the arguments and defaults of the reference's
``stress/<name>.py``, adds ``--device`` (``cuda`` by default; without a
card and without ``--device cpu`` it raises ``DeviceUnavailable``), prints
its report as one JSON line and exits nonzero when one of its checks
fails. ``main(...)`` returns the report dict.
"""
