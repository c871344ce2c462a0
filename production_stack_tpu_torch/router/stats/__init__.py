"""Engine metric vocabulary: the ``tpu:`` names the router scrapes."""
