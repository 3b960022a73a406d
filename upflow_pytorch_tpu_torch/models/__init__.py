"""The networks (UPFlow, RAFT) and their serving entry (``entry``)."""
