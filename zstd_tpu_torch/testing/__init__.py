"""Test and benchmark helpers: the libzstd oracle and the bench corpus."""
