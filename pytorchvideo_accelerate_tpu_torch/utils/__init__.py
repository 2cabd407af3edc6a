"""Small stdlib helpers of the port (`sync.py`: lock creation and the
shared-state declarations of the threaded classes)."""
