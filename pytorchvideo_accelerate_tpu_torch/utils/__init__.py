"""Small helpers of the port: `sync.py` (lock creation and the shared-state
declarations of the threaded classes), `device_doctor.py` (the
`--device_init_timeout` probe) and `debug_nans.py` (the `--debug_nans`
traps)."""
