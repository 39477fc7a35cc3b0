"""Input pipelines of the port: the TPUREC01 record format and its reader."""
