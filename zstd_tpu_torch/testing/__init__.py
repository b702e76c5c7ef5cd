"""Test and benchmark helpers: the libzstd oracle, the bench corpus and
the multi-process scaling bench."""
