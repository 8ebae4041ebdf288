from langstream_tpu_torch.grpc_runtime.service import main

main()
