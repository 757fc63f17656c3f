"""Traffic: the scan streams a cell sends (scans.py, the one generator)
and the mixes and scenes it reads (<mix>.json, scenes/<scene>.json)."""
