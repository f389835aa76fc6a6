"""The file-system plane: master, metanodes, datanodes, the client and the
cold tier onto the blob plane (host code; the card enters through the
tier's blob codec)."""
