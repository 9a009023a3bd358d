"""The experiments of pcx on the port: parameter ablations, precision and
order studies, structural checks and the runtime table (``python -m
pcx_torch.experiments NAME``)."""
