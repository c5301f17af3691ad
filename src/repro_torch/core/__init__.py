"""Models (GCRN-M2, EvolveGCN-O) and plan executors of the port."""
