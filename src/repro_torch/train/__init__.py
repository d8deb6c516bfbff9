"""Training support of the port (counterpart of ``src/repro/train/``): so
far only the heartbeat failure detector that the serving router's leader
election runs on."""
