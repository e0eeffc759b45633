from dynamo_tpu_torch.control_plane_service import main

main()
