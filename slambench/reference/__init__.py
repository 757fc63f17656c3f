"""The plain reference that decides a run's `correct`: plain PyTorch that
imports nothing of the program under test (grid.py: the map, the exact
march, the push, the occupancy grid; slam.py: the settings, the start and
one localization step)."""
