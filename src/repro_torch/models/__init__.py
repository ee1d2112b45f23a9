"""Model definitions of the port: the dense LM family and the paper's
RecSys models (YoutubeDNN, DLRM), with their training losses."""
