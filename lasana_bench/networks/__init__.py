"""One module per configuration ``network``: the program's spec, the
reference, the stimulus and the comparison of their records."""
