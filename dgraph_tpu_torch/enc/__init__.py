from dgraph_tpu_torch.enc.enc import encrypt_stream, decrypt_stream, read_key_file
