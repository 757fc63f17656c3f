"""The benchmark's own tests: `python -m pytest slambench/tests` on the
CPU; on the card `python -m pytest slambench/tests -m cuda`."""
