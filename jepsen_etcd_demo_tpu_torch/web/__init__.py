"""web: the store browser and the serving process's /metrics and /healthz
(server.py)."""
