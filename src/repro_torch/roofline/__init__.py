"""The roofline of the port's plan on an H100: hardware constants and the
three-term analysis the dry-run writes (``launch/dryrun.py``)."""
